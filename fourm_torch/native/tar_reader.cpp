// Native tar shard reader of the fourm_torch data pipeline: the port's own
// copy of fourm_tpu/native/tar_reader.cpp.
//
// The input pipeline streams thousands of per-modality tar shards
// (data/datasets.py); Python's tarfile walks headers with interpreter-bound
// seeks and per-member object churn. This reader indexes a tar in one
// sequential pass (POSIX tar: 512-byte headers, octal size fields) and serves
// member reads via pread, so Python touches one ctypes call per member and the
// bytes land directly in a caller-provided buffer (zero Python-side copies).
// A small reader pool keeps per-shard file descriptors open across samples.
//
// Exposed C ABI (see fourm_torch/native/__init__.py for the ctypes bindings):
//   tar_open(path) -> handle (indexes the tar; <0 on error)
//   tar_num_members(handle)
//   tar_member_name(handle, i, out, cap)
//   tar_member_size(handle, i)
//   tar_read_member(handle, i, out, cap) -> bytes read
//   tar_close(handle)

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fcntl.h>
#include <mutex>
#include <string>
#include <sys/stat.h>
#include <unistd.h>
#include <unordered_map>
#include <vector>

namespace {

struct Member {
  std::string name;
  uint64_t offset;  // offset of file data (past the header)
  uint64_t size;
};

struct TarIndex {
  int fd = -1;
  std::vector<Member> members;
};

std::mutex g_mu;
std::unordered_map<int64_t, TarIndex*> g_handles;
int64_t g_next_handle = 1;

uint64_t parse_octal(const char* p, size_t n) {
  uint64_t v = 0;
  for (size_t i = 0; i < n && p[i]; i++) {
    if (p[i] < '0' || p[i] > '7') continue;
    v = (v << 3) | (uint64_t)(p[i] - '0');
  }
  return v;
}

}  // namespace

extern "C" {

int64_t tar_open(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return -1;

  auto* idx = new TarIndex();
  idx->fd = fd;

  char header[512];
  uint64_t pos = 0;
  std::string pending_longname;
  while (true) {
    ssize_t n = ::pread(fd, header, 512, (off_t)pos);
    if (n < 512) break;
    // two consecutive zero blocks terminate the archive
    bool all_zero = true;
    for (int i = 0; i < 512; i++) {
      if (header[i] != 0) { all_zero = false; break; }
    }
    if (all_zero) break;

    uint64_t size = parse_octal(header + 124, 12);
    char typeflag = header[156];
    uint64_t data_start = pos + 512;
    uint64_t padded = (size + 511) & ~511ULL;

    if (typeflag == 'L') {  // GNU long name: data block holds the real name
      std::vector<char> buf(size + 1, 0);
      if (::pread(fd, buf.data(), size, (off_t)data_start) == (ssize_t)size) {
        pending_longname.assign(buf.data());
      }
    } else if (typeflag == '0' || typeflag == 0 || typeflag == '\0') {
      Member m;
      if (!pending_longname.empty()) {
        m.name = pending_longname;
        pending_longname.clear();
      } else {
        char name[257] = {0};
        // ustar prefix field (345..499) + name field (0..99)
        char prefix[156] = {0};
        memcpy(prefix, header + 345, 155);
        memcpy(name, header, 100);
        if (prefix[0]) {
          m.name = std::string(prefix) + "/" + std::string(name);
        } else {
          m.name = std::string(name);
        }
      }
      m.offset = data_start;
      m.size = size;
      idx->members.push_back(std::move(m));
    }
    pos = data_start + padded;
  }

  std::lock_guard<std::mutex> lk(g_mu);
  int64_t h = g_next_handle++;
  g_handles[h] = idx;
  return h;
}

int64_t tar_num_members(int64_t handle) {
  std::lock_guard<std::mutex> lk(g_mu);
  auto it = g_handles.find(handle);
  if (it == g_handles.end()) return -1;
  return (int64_t)it->second->members.size();
}

int64_t tar_member_name(int64_t handle, int64_t i, char* out, int64_t cap) {
  TarIndex* idx;
  {
    std::lock_guard<std::mutex> lk(g_mu);
    auto it = g_handles.find(handle);
    if (it == g_handles.end()) return -1;
    idx = it->second;
  }
  if (i < 0 || (size_t)i >= idx->members.size()) return -1;
  const std::string& name = idx->members[i].name;
  int64_t n = (int64_t)name.size();
  if (n + 1 > cap) return -(n + 1);
  memcpy(out, name.c_str(), n + 1);
  return n;
}

int64_t tar_member_size(int64_t handle, int64_t i) {
  std::lock_guard<std::mutex> lk(g_mu);
  auto it = g_handles.find(handle);
  if (it == g_handles.end()) return -1;
  if (i < 0 || (size_t)i >= it->second->members.size()) return -1;
  return (int64_t)it->second->members[i].size;
}

int64_t tar_read_member(int64_t handle, int64_t i, uint8_t* out, int64_t cap) {
  TarIndex* idx;
  {
    std::lock_guard<std::mutex> lk(g_mu);
    auto it = g_handles.find(handle);
    if (it == g_handles.end()) return -1;
    idx = it->second;
  }
  if (i < 0 || (size_t)i >= idx->members.size()) return -1;
  const Member& m = idx->members[i];
  if ((int64_t)m.size > cap) return -(int64_t)m.size;
  int64_t total = 0;
  while (total < (int64_t)m.size) {
    ssize_t n = ::pread(idx->fd, out + total, m.size - total,
                        (off_t)(m.offset + total));
    if (n <= 0) return -1;
    total += n;
  }
  return total;
}

void tar_close(int64_t handle) {
  TarIndex* idx = nullptr;
  {
    std::lock_guard<std::mutex> lk(g_mu);
    auto it = g_handles.find(handle);
    if (it == g_handles.end()) return;
    idx = it->second;
    g_handles.erase(it);
  }
  if (idx) {
    ::close(idx->fd);
    delete idx;
  }
}

}  // extern "C"
