// Native capture-source harness over the frame bus.
//
// Capability parity with the reference's C++ capture framework
// (reference include/capture_source.hpp:27-186, lib/capture_source.cpp:17-39):
// thread-per-UDL with a shared quit flag (any UDL exception or exhaustion
// unwinds every sibling), lazily-created per-direction bus blocks sized from
// the first frame, typed single-plane writes and named multi-plane writes,
// and a sleep-to-rate FpsLimiter returning epoch-milliseconds.
#pragma once

#include <atomic>
#include <chrono>
#include <cstdio>
#include <functional>
#include <memory>
#include <string>
#include <thread>
#include <unordered_map>
#include <utility>
#include <vector>

#include "framebus.hpp"

namespace capture {

class QuitFlag {
public:
    bool is_set() const noexcept { return _flag.load(std::memory_order_acquire); }
    void set() noexcept { _flag.store(true, std::memory_order_release); }

private:
    std::atomic<bool> _flag{false};
};

/// Sleep-to-rate limiter; tick() returns epoch milliseconds
/// (reference lib/capture_source.cpp:17-27).
class FpsLimiter {
public:
    explicit FpsLimiter(double fps) {
        _period = fps > 0 ? std::chrono::duration<double>(1.0 / fps)
                          : std::chrono::duration<double>(0);
        _last = std::chrono::steady_clock::now();
    }

    std::uint64_t tick() {
        auto now = std::chrono::steady_clock::now();
        auto elapsed = now - _last;
        if (elapsed < _period) {
            std::this_thread::sleep_for(_period - elapsed);
        }
        _last = std::chrono::steady_clock::now();
        return std::chrono::duration_cast<std::chrono::milliseconds>(
                   std::chrono::system_clock::now().time_since_epoch())
            .count();
    }

private:
    std::chrono::duration<double> _period{};
    std::chrono::steady_clock::time_point _last;
};

class CaptureSource {
public:
    using Udl = std::function<void(CaptureSource&, QuitFlag&)>;

    ~CaptureSource() { join(); }

    /// Register a user-defined loop; exceptions set the shared quit flag
    /// (reference capture_source.hpp:72-110).
    void register_udl(const std::string& name, Udl fn) {
        _threads.emplace_back([this, name, fn = std::move(fn)]() {
            try {
                fn(*this, _quit);
            } catch (const std::exception& e) {
                std::fprintf(stderr, "[capture:%s] exception: %s\n",
                             name.c_str(), e.what());
            }
            _quit.set();
        });
    }

    /// Single-plane typed write; block lazily created and sized from the
    /// first frame (reference capture_source.hpp:123-180).
    template <typename T>
    int write_image(const std::string& direction, std::uint64_t time_ms,
                    std::size_t width, std::size_t height, std::size_t depth,
                    const T* data) {
        framebus::PlaneWrite plane{width, height, depth, sizeof(T), data,
                                   nullptr};
        return write_planes(direction, time_ms, &plane, 1);
    }

    int write_planes(const std::string& direction, std::uint64_t time_ms,
                     const framebus::PlaneWrite* planes,
                     std::size_t plane_count) {
        auto it = _blocks.find(direction);
        if (it == _blocks.end()) {
            std::size_t total = 0;
            for (std::size_t i = 0; i < plane_count; ++i) {
                const auto& p = planes[i];
                total = (total + 127) / 128 * 128;
                total += p.width * p.height * p.depth * p.type_size;
            }
            it = _blocks
                     .emplace(direction, std::make_unique<framebus::Bus>(
                                             direction, total))
                     .first;
        }
        return it->second->write(time_ms, planes, plane_count);
    }

    /// Start all UDL threads and block until the quit flag fires.
    void run_until_complete() {
        while (!_quit.is_set()) {
            std::this_thread::sleep_for(std::chrono::milliseconds(100));
        }
        join();
    }

    QuitFlag& quit_flag() noexcept { return _quit; }

private:
    void join() {
        _quit.set();
        for (auto& t : _threads) {
            if (t.joinable()) {
                t.join();
            }
        }
        _threads.clear();
    }

    QuitFlag _quit;
    std::vector<std::thread> _threads;
    std::unordered_map<std::string, std::unique_ptr<framebus::Bus>> _blocks;
};

} // namespace capture
