// TEST STUB of the Spinnaker SDK surface used by src/flir_capture.cpp —
// see test_stubs/zed/sl/Camera.hpp for the rationale. Compile+link proof
// AND a synthetic frame producer: GetNextImage yields deterministic BGR
// frames so the capture UDL (acquire -> convert -> bus write,
// flir_capture.cpp:78-115) executes under test. Never shipped.
#pragma once

#include <chrono>
#include <cstddef>
#include <cstdint>
#include <memory>
#include <string>
#include <thread>
#include <vector>

namespace Spinnaker {

enum PixelFormatEnums { PixelFormat_BGR8 };
enum ColorProcessingAlgorithm { HQ_LINEAR };

namespace GenApi {

class INode;

class CIntegerPtr {
  public:
    explicit CIntegerPtr(INode*) {}
    CIntegerPtr* operator->() { return this; }
    void SetValue(std::int64_t) {}
};

class CBooleanPtr {
  public:
    explicit CBooleanPtr(INode*) {}
    CBooleanPtr* operator->() { return this; }
    void SetValue(bool) {}
};

class CFloatPtr {
  public:
    explicit CFloatPtr(INode*) {}
    CFloatPtr* operator->() { return this; }
    void SetValue(double) {}
};

class CEnumerationPtr {
  public:
    explicit CEnumerationPtr(INode*) {}
    CEnumerationPtr* operator->() { return this; }
    void SetIntValue(std::int64_t) {}
};

class INodeMap {
  public:
    INode* GetNode(const char*) { return nullptr; }
};

}  // namespace GenApi

constexpr std::size_t kStubW = 160;
constexpr std::size_t kStubH = 120;

class ImagePtr;

class Image {
  public:
    bool IsIncomplete() const { return false; }
    void Release() {}
    std::size_t GetWidth() const { return kStubW; }
    std::size_t GetHeight() const { return kStubH; }
    void* GetData() const {
        return const_cast<unsigned char*>(data_.data());
    }
    ImagePtr Convert(PixelFormatEnums, ColorProcessingAlgorithm) const;

    void fill_bgr(std::uint64_t frame) {
        data_.resize(kStubW * kStubH * 3);
        for (std::size_t y = 0; y < kStubH; ++y) {
            for (std::size_t x = 0; x < kStubW; ++x) {
                unsigned char* px = data_.data() + (y * kStubW + x) * 3;
                px[0] = static_cast<unsigned char>((x + frame) & 0xFF);  // B
                px[1] = static_cast<unsigned char>(y & 0xFF);            // G
                px[2] = 77;                                              // R
            }
        }
    }

  private:
    std::vector<unsigned char> data_;
};

class ImagePtr {
  public:
    ImagePtr() : img_(std::make_shared<Image>()) {}
    Image* operator->() const { return img_.get(); }
    Image& get() const { return *img_; }

  private:
    std::shared_ptr<Image> img_;
};

inline ImagePtr Image::Convert(PixelFormatEnums,
                               ColorProcessingAlgorithm) const {
    ImagePtr out;
    out.get() = *this;  // already BGR in the stub
    return out;
}

class Camera {
  public:
    void Init() {}
    void DeInit() {}
    GenApi::INodeMap& GetNodeMap() { return nodemap_; }
    void BeginAcquisition() {}
    void EndAcquisition() {}
    ImagePtr GetNextImage(int) {
        // pace like a real device; the UDL's FpsLimiter also rate-caps
        std::this_thread::sleep_for(std::chrono::milliseconds(10));
        ImagePtr img;
        img.get().fill_bgr(frame_++);
        return img;
    }

  private:
    GenApi::INodeMap nodemap_;
    std::uint64_t frame_ = 0;
};

class CameraPtr {
  public:
    CameraPtr() : cam_(std::make_shared<Camera>()) {}
    bool IsValid() const { return true; }
    Camera* operator->() const { return cam_.get(); }

  private:
    std::shared_ptr<Camera> cam_;
};

class CameraList {
  public:
    CameraPtr GetBySerial(const std::string&) { return CameraPtr(); }
    void Clear() {}
};

class System;

class SystemPtr {
  public:
    System* operator->() const;
};

class System {
  public:
    static SystemPtr GetInstance() { return SystemPtr(); }
    CameraList GetCameras() { return CameraList(); }
    void ReleaseInstance() {}
};

inline System* SystemPtr::operator->() const {
    static System system;
    return &system;
}

}  // namespace Spinnaker
