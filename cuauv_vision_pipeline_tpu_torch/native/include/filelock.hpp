// RAII exclusive inter-process file lock.
//
// TPU-native rebuild of the reference's filelock layer
// (reference: lib/filelock.cpp:12-31, include/filelock.hpp) — same capability
// (serialize shared-memory block creation across processes) with a
// header-only implementation.
#pragma once

#include <cerrno>
#include <cstring>
#include <stdexcept>
#include <string>

#include <fcntl.h>
#include <sys/file.h>
#include <sys/stat.h>
#include <unistd.h>

namespace framebus {

class Filelock {
public:
    explicit Filelock(const std::string& path) {
        _fd = ::open(path.c_str(), O_CREAT | O_RDWR, 0666);
        if (_fd < 0) {
            throw std::runtime_error("Filelock: cannot open " + path + ": " +
                                     std::string(::strerror(errno)));
        }
        // Retry on EINTR; LOCK_EX blocks until acquired.
        while (::flock(_fd, LOCK_EX) != 0) {
            if (errno != EINTR) {
                int e = errno;
                ::close(_fd);
                _fd = -1;
                throw std::runtime_error("Filelock: flock failed on " + path +
                                         ": " + std::string(::strerror(e)));
            }
        }
    }

    Filelock(const Filelock&) = delete;
    Filelock& operator=(const Filelock&) = delete;

    ~Filelock() noexcept {
        if (_fd >= 0) {
            ::flock(_fd, LOCK_UN);
            ::close(_fd);
        }
    }

private:
    int _fd = -1;
};

} // namespace framebus
