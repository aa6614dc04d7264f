// ZED stereo capture binary (vehicle-only; requires the ZED SDK + CUDA).
//
// Capability parity with the reference's production source
// (reference capture_sources/zed.cpp:29-297): opens the SDK at HD720 /
// NEURAL depth / METER units / 0.5-10 m (zed.cpp:267-277); a 10 fps capture
// UDL grabs LEFT/RIGHT images + DEPTH (f32) + NORMALS, converts RGBA->RGB
// and normals [-1,1]->[0,1] (zed.cpp:54-91), and publishes ONE aggregated
// 4-plane frame on direction "zed" with plane names forward/forward2/depth/
// normal (zed.cpp:139-214); a 2 fps UDL pushes the calibration shm group
// into the camera with auto-exposure/AWB off (zed.cpp:218-253).
//
// Build only when the SDK is present:
//   python -m cuauv_vision_pipeline_tpu_torch.native zed_capture  (gated on ZED_SDK_ROOT)
//
// Calibration values are read from the Python shm store's mmap'd group file
// (core/shm.py layout) so the C++ source and Python modules share state
// without a libshm dependency.

#ifdef HAVE_ZED_SDK

#include <sl/Camera.hpp>

#include <cstring>
#include <vector>

#include "capture_harness.hpp"
#include "shm_store.hpp"

namespace {

constexpr int kCaptureFps = 10;
constexpr int kCalibFps = 2;

void rgba_to_rgb(const sl::Mat& src, std::vector<unsigned char>& dst) {
    const size_t w = src.getWidth();
    const size_t h = src.getHeight();
    dst.resize(w * h * 3);
    const unsigned char* in = src.getPtr<sl::uchar1>();
    // memory-bandwidth-bound tight loop (reference zed.cpp:54-65)
    for (size_t i = 0; i < w * h; ++i) {
        dst[i * 3 + 0] = in[i * 4 + 0];
        dst[i * 3 + 1] = in[i * 4 + 1];
        dst[i * 3 + 2] = in[i * 4 + 2];
    }
}

void normals_to_01(const sl::Mat& src, std::vector<float>& dst) {
    const size_t w = src.getWidth();
    const size_t h = src.getHeight();
    dst.resize(w * h * 3);
    const float* in = src.getPtr<sl::float1>();
    for (size_t i = 0; i < w * h; ++i) {
        for (size_t c = 0; c < 3; ++c) {
            float v = in[i * 4 + c];
            if (!std::isfinite(v)) v = 0.f;
            dst[i * 3 + c] = (v + 1.f) * 0.5f;  // reference zed.cpp:84-91
        }
    }
}

void capture_udl(capture::CaptureSource& cs, capture::QuitFlag& quit,
                 sl::Camera* zed) {
    capture::FpsLimiter limiter(kCaptureFps);
    sl::Mat left, right, depth, normals;
    std::vector<unsigned char> left_rgb, right_rgb;
    std::vector<float> normal01, depth_clean;

    while (!quit.is_set()) {
        const std::uint64_t t = limiter.tick();
        if (zed->grab() != sl::ERROR_CODE::SUCCESS) continue;
        zed->retrieveImage(left, sl::VIEW::LEFT);
        zed->retrieveImage(right, sl::VIEW::RIGHT);
        zed->retrieveMeasure(depth, sl::MEASURE::DEPTH);
        zed->retrieveMeasure(normals, sl::MEASURE::NORMALS);

        rgba_to_rgb(left, left_rgb);
        rgba_to_rgb(right, right_rgb);
        normals_to_01(normals, normal01);

        const size_t w = left.getWidth();
        const size_t h = left.getHeight();
        depth_clean.assign(depth.getPtr<sl::float1>(),
                           depth.getPtr<sl::float1>() + w * h);
        for (float& v : depth_clean) {
            if (!std::isfinite(v)) v = 0.f;
        }

        framebus::PlaneWrite planes[4] = {
            {w, h, 3, 1, right_rgb.data(), "forward"},
            {w, h, 3, 1, left_rgb.data(), "forward2"},
            {w, h, 1, 4, depth_clean.data(), "depth"},
            {w, h, 3, 4, normal01.data(), "normal"},
        };
        cs.write_planes("zed", t, planes, 4);
    }
}

void calib_udl(capture::CaptureSource&, capture::QuitFlag& quit,
               sl::Camera* zed) {
    capture::FpsLimiter limiter(kCalibFps);
    shmstore::Group calib("zed_calibration");
    double last[16] = {};
    const std::pair<const char*, sl::VIDEO_SETTINGS> fields[] = {
        {"brightness", sl::VIDEO_SETTINGS::BRIGHTNESS},
        {"contrast", sl::VIDEO_SETTINGS::CONTRAST},
        {"hue", sl::VIDEO_SETTINGS::HUE},
        {"saturation", sl::VIDEO_SETTINGS::SATURATION},
        {"gamma", sl::VIDEO_SETTINGS::GAMMA},
        {"sharpness", sl::VIDEO_SETTINGS::SHARPNESS},
        {"white_balance", sl::VIDEO_SETTINGS::WHITEBALANCE_TEMPERATURE},
        {"zed_exposure", sl::VIDEO_SETTINGS::EXPOSURE},
        {"zed_gain", sl::VIDEO_SETTINGS::GAIN},
    };
    while (!quit.is_set()) {
        limiter.tick();
        int i = 0;
        for (const auto& [name, setting] : fields) {
            double v = calib.read_double(name);
            if (v != last[i]) {
                last[i] = v;
                zed->setCameraSettings(setting, static_cast<int>(v));
            }
            ++i;
        }
    }
}

} // namespace

int main() {
    sl::InitParameters init;
    init.camera_resolution = sl::RESOLUTION::HD720;
    init.depth_mode = sl::DEPTH_MODE::NEURAL;
    init.coordinate_units = sl::UNIT::METER;
    init.depth_minimum_distance = 0.5f;
    init.depth_maximum_distance = 10.f;

    sl::Camera zed;
    if (zed.open(init) != sl::ERROR_CODE::SUCCESS) {
        std::fprintf(stderr, "zed: open failed\n");
        return 1;
    }
    zed.setCameraSettings(sl::VIDEO_SETTINGS::AEC_AGC, 0);
    zed.setCameraSettings(sl::VIDEO_SETTINGS::WHITEBALANCE_AUTO, 0);

    capture::CaptureSource cs;
    cs.register_udl("zed capture", [&](auto& c, auto& q) {
        capture_udl(c, q, &zed);
    });
    cs.register_udl("zed calib", [&](auto& c, auto& q) {
        calib_udl(c, q, &zed);
    });
    cs.run_until_complete();
    return 0;
}

#else  // !HAVE_ZED_SDK

#include <cstdio>

int main() {
    std::fprintf(
        stderr,
        "zed_capture was built without the ZED SDK (set ZED_SDK_ROOT and "
        "rebuild on the vehicle); use the synthetic/video capture sources "
        "on dev machines.\n");
    return 1;
}

#endif
