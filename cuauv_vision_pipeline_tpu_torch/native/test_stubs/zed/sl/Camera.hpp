// TEST STUB of the ZED SDK surface used by src/zed_capture.cpp.
// Mirrors the subset of <sl/Camera.hpp> (types, enums, method signatures)
// so `python -m cuauv_vision_pipeline_tpu_torch.native stubcheck` can fully compile + link the vehicle-only binary on
// machines without the SDK (reference gates the same way,
// reference configure.py:42-86) — AND synthesizes deterministic frames so
// the capture UDL (grab -> retrieve -> RGBA->RGB / normal mapping -> bus
// write, zed_capture.cpp:61-96) actually EXECUTES under test: a Python
// reader asserts the 4-plane aggregate frame end to end. Never shipped.
#pragma once

#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <limits>
#include <thread>
#include <vector>

namespace sl {

using uchar1 = unsigned char;
using float1 = float;

enum class ERROR_CODE { SUCCESS = 0, FAILURE = 1 };
enum class VIEW { LEFT, RIGHT };
enum class MEASURE { DEPTH, NORMALS };
enum class RESOLUTION { HD720, HD1080 };
enum class DEPTH_MODE { NEURAL, ULTRA, PERFORMANCE };
enum class UNIT { METER, MILLIMETER };
enum class VIDEO_SETTINGS {
    BRIGHTNESS,
    CONTRAST,
    HUE,
    SATURATION,
    GAMMA,
    SHARPNESS,
    WHITEBALANCE_TEMPERATURE,
    WHITEBALANCE_AUTO,
    EXPOSURE,
    GAIN,
    AEC_AGC,
};

// Small synthetic resolution: the UDL reads sizes off the Mat, so the
// pipeline is exercised identically to HD720 at a fraction of the bytes.
constexpr std::size_t kStubW = 320;
constexpr std::size_t kStubH = 180;

class Mat {
  public:
    std::size_t getWidth() const { return w_; }
    std::size_t getHeight() const { return h_; }
    template <typename T>
    T* getPtr() const {
        return reinterpret_cast<T*>(const_cast<unsigned char*>(data_.data()));
    }

    void fill_rgba(std::uint64_t frame, unsigned char view_marker) {
        w_ = kStubW;
        h_ = kStubH;
        data_.resize(w_ * h_ * 4);
        for (std::size_t y = 0; y < h_; ++y) {
            for (std::size_t x = 0; x < w_; ++x) {
                unsigned char* px = data_.data() + (y * w_ + x) * 4;
                px[0] = static_cast<unsigned char>((x + frame) & 0xFF);
                px[1] = static_cast<unsigned char>(y & 0xFF);
                px[2] = view_marker;
                px[3] = 255;
            }
        }
    }

    void fill_depth() {
        w_ = kStubW;
        h_ = kStubH;
        data_.resize(w_ * h_ * sizeof(float));
        float* f = reinterpret_cast<float*>(data_.data());
        for (std::size_t i = 0; i < w_ * h_; ++i) f[i] = 2.5f;
        // first pixel NaN: exercises the UDL's finite-scrub (-> 0.0)
        f[0] = std::numeric_limits<float>::quiet_NaN();
    }

    void fill_normals() {
        w_ = kStubW;
        h_ = kStubH;
        data_.resize(w_ * h_ * 4 * sizeof(float));
        float* f = reinterpret_cast<float*>(data_.data());
        for (std::size_t i = 0; i < w_ * h_; ++i) {
            f[i * 4 + 0] = 1.0f;   // -> 1.0 after [-1,1] -> [0,1]
            f[i * 4 + 1] = -1.0f;  // -> 0.0
            f[i * 4 + 2] = 0.0f;   // -> 0.5
            f[i * 4 + 3] = 0.0f;
        }
        f[0] = std::numeric_limits<float>::quiet_NaN();  // -> 0 -> 0.5
    }

  private:
    std::size_t w_ = 0;
    std::size_t h_ = 0;
    std::vector<unsigned char> data_;
};

struct InitParameters {
    RESOLUTION camera_resolution = RESOLUTION::HD720;
    DEPTH_MODE depth_mode = DEPTH_MODE::NEURAL;
    UNIT coordinate_units = UNIT::METER;
    float depth_minimum_distance = 0.f;
    float depth_maximum_distance = 0.f;
};

class Camera {
  public:
    ERROR_CODE open(const InitParameters&) { return ERROR_CODE::SUCCESS; }

    ERROR_CODE grab() {
        // pace the synthetic camera so the stubcheck binary behaves like a
        // real (slow) device rather than a busy loop
        std::this_thread::sleep_for(std::chrono::milliseconds(15));
        ++frame_;
        return ERROR_CODE::SUCCESS;
    }

    ERROR_CODE retrieveImage(Mat& m, VIEW v) {
        m.fill_rgba(frame_, v == VIEW::LEFT ? 100 : 200);
        return ERROR_CODE::SUCCESS;
    }

    ERROR_CODE retrieveMeasure(Mat& m, MEASURE which) {
        if (which == MEASURE::DEPTH) {
            m.fill_depth();
        } else {
            m.fill_normals();
        }
        return ERROR_CODE::SUCCESS;
    }

    void setCameraSettings(VIDEO_SETTINGS, int) {}
    void close() {}

  private:
    std::uint64_t frame_ = 0;
};

}  // namespace sl
