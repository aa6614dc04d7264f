// FLIR (Spinnaker) multi-camera capture binary (vehicle-only).
//
// Capability parity with the reference (reference capture_sources/
// flir.cpp:34-235): parses a TOML config of [[camera]] tables
// {serial, direction, width, height, fps, binning_horizontal,
// binning_vertical} (flir.cpp:34-87); per camera a capture UDL converts to
// BGR8 and writes one plane per direction (flir.cpp:144-174); a
// param-update UDL watches the flir_calibration shm group and applies
// manual exposure (flir.cpp:176-194).
//
// Build only when the Spinnaker SDK is present (python -m cuauv_vision_pipeline_tpu_torch.native
// flir_capture, gated on SPINNAKER_ROOT).

#include <cstdio>
#include <fstream>
#include <sstream>
#include <string>
#include <vector>

struct FlirConfig {
    std::string serial;
    std::string direction;
    int width = 0;
    int height = 0;
    double fps = 15.0;
    int binning_h = 1;
    int binning_v = 1;
};

// Minimal TOML subset parser: [[camera]] tables with key = value lines
// (the reference used a full TOML library for the same shape,
// flir.cpp:54-87).
static std::vector<FlirConfig> parse_flir_config(const std::string& path) {
    std::vector<FlirConfig> configs;
    std::ifstream in(path);
    std::string line;
    while (std::getline(in, line)) {
        auto first = line.find_first_not_of(" \t");
        if (first == std::string::npos) continue;
        line = line.substr(first);
        if (line.rfind("[[camera]]", 0) == 0) {
            configs.emplace_back();
            continue;
        }
        if (configs.empty() || line[0] == '#') continue;
        auto eq = line.find('=');
        if (eq == std::string::npos) continue;
        auto trim = [](std::string s) {
            auto a = s.find_first_not_of(" \t\"");
            auto b = s.find_last_not_of(" \t\r\"");
            return a == std::string::npos ? std::string()
                                          : s.substr(a, b - a + 1);
        };
        const std::string key = trim(line.substr(0, eq));
        const std::string value = trim(line.substr(eq + 1));
        FlirConfig& cfg = configs.back();
        if (key == "serial") cfg.serial = value;
        else if (key == "direction") cfg.direction = value;
        else if (key == "width") cfg.width = std::stoi(value);
        else if (key == "height") cfg.height = std::stoi(value);
        else if (key == "fps") cfg.fps = std::stod(value);
        else if (key == "binning_horizontal") cfg.binning_h = std::stoi(value);
        else if (key == "binning_vertical") cfg.binning_v = std::stoi(value);
    }
    return configs;
}

#ifdef HAVE_SPINNAKER

#include <Spinnaker.h>
#include <SpinGenApi/SpinnakerGenApi.h>

#include "capture_harness.hpp"
#include "shm_store.hpp"

using namespace Spinnaker;

static void capture_udl(capture::CaptureSource& cs, capture::QuitFlag& quit,
                        CameraPtr camera, FlirConfig cfg) {
    camera->Init();
    auto& nodemap = camera->GetNodeMap();
    // resolution / binning / framerate (reference flir.cpp:108-136)
    GenApi::CIntegerPtr(nodemap.GetNode("BinningHorizontal"))
        ->SetValue(cfg.binning_h);
    GenApi::CIntegerPtr(nodemap.GetNode("BinningVertical"))
        ->SetValue(cfg.binning_v);
    if (cfg.width) {
        GenApi::CIntegerPtr(nodemap.GetNode("Width"))->SetValue(cfg.width);
    }
    if (cfg.height) {
        GenApi::CIntegerPtr(nodemap.GetNode("Height"))->SetValue(cfg.height);
    }
    GenApi::CBooleanPtr(nodemap.GetNode("AcquisitionFrameRateEnable"))
        ->SetValue(true);
    GenApi::CFloatPtr(nodemap.GetNode("AcquisitionFrameRate"))
        ->SetValue(cfg.fps);
    camera->BeginAcquisition();

    capture::FpsLimiter limiter(cfg.fps);
    while (!quit.is_set()) {
        const std::uint64_t t = limiter.tick();
        ImagePtr raw = camera->GetNextImage(1000);
        if (raw->IsIncomplete()) {
            raw->Release();
            continue;
        }
        ImagePtr bgr = raw->Convert(PixelFormat_BGR8, HQ_LINEAR);
        cs.write_image<unsigned char>(
            cfg.direction, t, bgr->GetWidth(), bgr->GetHeight(), 3,
            static_cast<unsigned char*>(bgr->GetData()));
        raw->Release();
    }
    camera->EndAcquisition();
    camera->DeInit();
}

static void param_udl(capture::CaptureSource&, capture::QuitFlag& quit,
                      CameraPtr camera) {
    capture::FpsLimiter limiter(2);
    shmstore::Group calib("flir_calibration");
    double last_exposure = -1;
    while (!quit.is_set()) {
        limiter.tick();
        if (calib.read_double("manual_exposure") != 0.0) {
            double exposure = calib.read_double("exposure_us");
            if (exposure != last_exposure) {
                last_exposure = exposure;
                auto& nodemap = camera->GetNodeMap();
                GenApi::CEnumerationPtr(nodemap.GetNode("ExposureAuto"))
                    ->SetIntValue(0);
                GenApi::CFloatPtr(nodemap.GetNode("ExposureTime"))
                    ->SetValue(exposure);
            }
        }
    }
}

int main(int argc, char** argv) {
    const std::string config_path =
        argc > 1 ? argv[1] : "configs/flir.conf";
    auto configs = parse_flir_config(config_path);
    if (configs.empty()) {
        std::fprintf(stderr, "flir: no cameras in %s\n", config_path.c_str());
        return 1;
    }

    SystemPtr system = System::GetInstance();
    CameraList cameras = system->GetCameras();
    capture::CaptureSource cs;
    for (const auto& cfg : configs) {
        CameraPtr camera = cameras.GetBySerial(cfg.serial);
        if (!camera.IsValid()) {
            std::fprintf(stderr, "flir: serial %s not found\n",
                         cfg.serial.c_str());
            continue;
        }
        cs.register_udl("flir " + cfg.direction, [camera, cfg](auto& c, auto& q) {
            capture_udl(c, q, camera, cfg);
        });
        cs.register_udl("flir params " + cfg.direction,
                        [camera](auto& c, auto& q) { param_udl(c, q, camera); });
    }
    cs.run_until_complete();
    cameras.Clear();
    system->ReleaseInstance();
    return 0;
}

#else  // !HAVE_SPINNAKER

int main(int argc, char** argv) {
    // config parsing stays testable without the SDK
    if (argc > 2 && std::string(argv[1]) == "--parse-only") {
        auto configs = parse_flir_config(argv[2]);
        for (const auto& c : configs) {
            std::printf("camera serial=%s direction=%s %dx%d @%.1ffps bin=%dx%d\n",
                        c.serial.c_str(), c.direction.c_str(), c.width,
                        c.height, c.fps, c.binning_h, c.binning_v);
        }
        return configs.empty() ? 1 : 0;
    }
    std::fprintf(stderr,
                 "flir_capture was built without the Spinnaker SDK (set "
                 "SPINNAKER_ROOT and rebuild on the vehicle).\n");
    return 1;
}

#endif
