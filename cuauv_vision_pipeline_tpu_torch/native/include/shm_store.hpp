// Minimal C++ reader/writer for the Python shm store's group files.
//
// The rebuild's typed variable store (core/shm.py) keeps each group in
// /dev/shm/auv_shm_<name> as: 8-byte magic, u64 seq, u32 schema_len, a JSON
// schema blob (sorted keys), then packed little-endian fields. Native
// capture binaries (zed/flir) need a handful of scalar reads/writes, so this
// header parses just that flat JSON shape ({"field": "type"} or
// {"field": ["type", default]}) — no external JSON dependency.
#pragma once

#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <stdexcept>
#include <string>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>
#include <vector>

namespace shmstore {

struct Field {
    std::string name;
    std::string type; // int | float | bool | string
    std::size_t offset = 0;
    std::size_t size = 0;
};

class Group {
public:
    explicit Group(const std::string& name) {
        const std::string path = "/dev/shm/auv_shm_" + name;
        _fd = ::open(path.c_str(), O_RDWR);
        if (_fd < 0) {
            throw std::runtime_error("shmstore: no such group: " + name +
                                     " (create it from Python first)");
        }
        struct stat st{};
        ::fstat(_fd, &st);
        _size = st.st_size;
        _base = static_cast<unsigned char*>(::mmap(
            nullptr, _size, PROT_READ | PROT_WRITE, MAP_SHARED, _fd, 0));
        if (_base == MAP_FAILED) {
            ::close(_fd);
            throw std::runtime_error("shmstore: mmap failed for " + name);
        }
        std::uint32_t schema_len;
        std::memcpy(&schema_len, _base + 16, 4);
        const std::string blob(reinterpret_cast<char*>(_base) + 20, schema_len);
        parse_schema(blob, 20 + schema_len);
    }

    ~Group() {
        if (_base && _base != MAP_FAILED) ::munmap(_base, _size);
        if (_fd >= 0) ::close(_fd);
    }

    double read_double(const std::string& name) const {
        const Field& f = find(name);
        if (f.type == "float") {
            double v;
            std::memcpy(&v, _base + f.offset, 8);
            return v;
        }
        if (f.type == "int") {
            std::int64_t v;
            std::memcpy(&v, _base + f.offset, 8);
            return static_cast<double>(v);
        }
        if (f.type == "bool") {
            return _base[f.offset] ? 1.0 : 0.0;
        }
        throw std::runtime_error("shmstore: non-numeric field " + name);
    }

    void write_double(const std::string& name, double value) {
        const Field& f = find(name);
        if (f.type == "float") {
            std::memcpy(_base + f.offset, &value, 8);
        } else if (f.type == "int") {
            std::int64_t v = static_cast<std::int64_t>(value);
            std::memcpy(_base + f.offset, &v, 8);
        } else if (f.type == "bool") {
            _base[f.offset] = value != 0.0 ? 1 : 0;
        } else {
            throw std::runtime_error("shmstore: non-numeric field " + name);
        }
        bump_seq();
    }

private:
    const Field& find(const std::string& name) const {
        for (const Field& f : _fields) {
            if (f.name == name) return f;
        }
        throw std::runtime_error("shmstore: no field " + name);
    }

    void bump_seq() {
        std::uint64_t seq;
        std::memcpy(&seq, _base + 8, 8);
        ++seq;
        std::memcpy(_base + 8, &seq, 8);
    }

    static std::size_t type_size(const std::string& t) {
        if (t == "int" || t == "float") return 8;
        if (t == "bool") return 1;
        if (t == "string") return 64;
        throw std::runtime_error("shmstore: unknown type " + t);
    }

    void parse_schema(const std::string& blob, std::size_t data_off) {
        // flat JSON object; keys and type strings are double-quoted tokens.
        std::size_t pos = 0;
        std::size_t offset = data_off;
        auto next_string = [&](std::size_t from,
                               std::string& out) -> std::size_t {
            std::size_t a = blob.find('"', from);
            if (a == std::string::npos) return std::string::npos;
            std::size_t b = blob.find('"', a + 1);
            if (b == std::string::npos) return std::string::npos;
            out = blob.substr(a + 1, b - a - 1);
            return b + 1;
        };
        while (true) {
            std::string key;
            pos = next_string(pos, key);
            if (pos == std::string::npos) break;
            std::size_t colon = blob.find(':', pos);
            if (colon == std::string::npos) break;
            std::string type;
            pos = next_string(colon, type); // first string after ':' is type
            if (pos == std::string::npos) break;
            // skip to the end of this value (next ',' at depth 0 handled
            // implicitly by looking for the next key string)
            Field f{key, type, offset, type_size(type)};
            offset += f.size;
            _fields.push_back(std::move(f));
            // skip past any array remainder like , 4600.0]
            std::size_t comma = blob.find(',', pos);
            std::size_t brace = blob.find('}', pos);
            pos = comma == std::string::npos ? brace : pos;
            if (pos == std::string::npos) break;
        }
        if (_fields.empty()) {
            throw std::runtime_error("shmstore: empty/unparsable schema");
        }
    }

    int _fd = -1;
    std::size_t _size = 0;
    unsigned char* _base = nullptr;
    std::vector<Field> _fields;
};

} // namespace shmstore
