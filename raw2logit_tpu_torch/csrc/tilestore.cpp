// raw2logit host data runtime: memory-mapped tile store + batcher (the
// port's copy of the JAX package's native/tilestore.cpp, built by
// raw2logit_tpu_torch/data/tilestore.py with the host C++ compiler).
//
// Tiles are decoded ONCE into a packed binary store; epochs then stream
// batches via mmap + a multithreaded gather that also normalises uint16 /
// uint8 to float32 in [0, 1]. C API consumed from Python via ctypes.
//
// File layout (.r2l), little-endian:
//   magic   u64  0x5232_4C54_494C_4531 ("R2LTILE1")
//   n       u64  number of items
//   h, w, c u64  tile geometry (c==0 -> one-channel (h, w) tiles)
//   dtype   u64  0=f32, 1=u16, 2=u8
//   label_kind u64  0=int64 scalar, 1=f32 mask (h*w per item)
//   data    n*h*w*max(c,1)*sizeof(dtype)
//   labels  n*8 bytes (kind 0) or n*h*w*4 (kind 1)

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <atomic>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Header {
  uint64_t magic, n, h, w, c, dtype, label_kind;
};

constexpr uint64_t kMagic = 0x52324C54494C4531ULL;

struct Store {
  int fd = -1;
  size_t file_size = 0;
  const uint8_t* base = nullptr;
  Header hdr{};
  const uint8_t* data = nullptr;
  const uint8_t* labels = nullptr;
  size_t item_bytes = 0;
  size_t label_bytes = 0;
};

size_t dtype_size(uint64_t d) { return d == 0 ? 4 : (d == 1 ? 2 : 1); }

void r2l_close_impl(Store* s) {
  if (!s) return;
  if (s->base) munmap(const_cast<uint8_t*>(s->base), s->file_size);
  if (s->fd >= 0) close(s->fd);
  delete s;
}

}  // namespace

extern "C" {

void* r2l_open(const char* path) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) { close(fd); return nullptr; }
  void* base = mmap(nullptr, st.st_size, PROT_READ, MAP_SHARED, fd, 0);
  if (base == MAP_FAILED) { close(fd); return nullptr; }
  auto* s = new Store();
  s->fd = fd;
  s->file_size = st.st_size;
  s->base = static_cast<const uint8_t*>(base);
  if (s->file_size < sizeof(Header)) { r2l_close_impl(s); return nullptr; }
  std::memcpy(&s->hdr, s->base, sizeof(Header));
  if (s->hdr.magic != kMagic) { r2l_close_impl(s); return nullptr; }
  // reject corrupt/hostile headers BEFORE any size arithmetic: the u64
  // geometry fields could wrap h*w*c*dtype and n*(item+label) products,
  // sneaking an undersized mapping past a multiplied bound and turning
  // the open-time guard into a SIGBUS mid-gather. Bound each factor,
  // then use division for the item-count check.
  if (s->hdr.h == 0 || s->hdr.w == 0 || s->hdr.h > (1u << 20) ||
      s->hdr.w > (1u << 20) || s->hdr.c > 64 || s->hdr.dtype > 2 ||
      s->hdr.label_kind > 1) {
    r2l_close_impl(s); return nullptr;
  }
  uint64_t cc = s->hdr.c ? s->hdr.c : 1;
  s->item_bytes = s->hdr.h * s->hdr.w * cc * dtype_size(s->hdr.dtype);
  s->label_bytes = s->hdr.label_kind == 0 ? 8 : s->hdr.h * s->hdr.w * 4;
  const uint64_t per_item = s->item_bytes + s->label_bytes;
  if (s->hdr.n > (s->file_size - sizeof(Header)) / per_item) {
    r2l_close_impl(s); return nullptr;
  }
  s->data = s->base + sizeof(Header);
  s->labels = s->data + s->hdr.n * s->item_bytes;
  // random-access gathers: don't queue whole-file readahead
  madvise(const_cast<uint8_t*>(s->base), s->file_size, MADV_RANDOM);
  return s;
}

void r2l_close(void* handle) {
  r2l_close_impl(static_cast<Store*>(handle));
}

uint64_t r2l_len(void* handle) {
  return static_cast<Store*>(handle)->hdr.n;
}

void r2l_shape(void* handle, uint64_t* out4) {
  auto* s = static_cast<Store*>(handle);
  out4[0] = s->hdr.h; out4[1] = s->hdr.w; out4[2] = s->hdr.c;
  out4[3] = s->hdr.dtype;
}

uint64_t r2l_label_kind(void* handle) {
  return static_cast<Store*>(handle)->hdr.label_kind;
}

// Gather a batch into caller-provided buffers, converting u16/u8 -> f32 in
// [0,1] on the fly (x * (1/(2^16-1)), x * (1/(2^8-1))). Threaded:
// splits the batch across n_threads.
void r2l_fill_batch(void* handle, const int64_t* indices, int64_t count,
                    float* out_images, void* out_labels, int n_threads) {
  auto* s = static_cast<Store*>(handle);
  const uint64_t cc = s->hdr.c ? s->hdr.c : 1;
  const size_t elems = s->hdr.h * s->hdr.w * cc;
  if (n_threads < 1) n_threads = 1;

  auto work = [&](int64_t lo, int64_t hi) {
    for (int64_t b = lo; b < hi; ++b) {
      const int64_t idx = indices[b];
      const uint8_t* src = s->data + idx * s->item_bytes;
      float* dst = out_images + b * elems;
      if (s->hdr.dtype == 0) {
        std::memcpy(dst, src, elems * 4);
      } else if (s->hdr.dtype == 1) {
        const uint16_t* p = reinterpret_cast<const uint16_t*>(src);
        constexpr float kInv = 1.0f / 65535.0f;
        for (size_t i = 0; i < elems; ++i) dst[i] = p[i] * kInv;
      } else {
        const uint8_t* p = src;
        constexpr float kInv = 1.0f / 255.0f;
        for (size_t i = 0; i < elems; ++i) dst[i] = p[i] * kInv;
      }
      const uint8_t* lsrc = s->labels + idx * s->label_bytes;
      if (s->hdr.label_kind == 0) {
        std::memcpy(static_cast<int64_t*>(out_labels) + b, lsrc, 8);
      } else {
        std::memcpy(static_cast<float*>(out_labels) +
                        b * s->hdr.h * s->hdr.w,
                    lsrc, s->label_bytes);
      }
    }
  };

  if (n_threads == 1 || count < 2 * n_threads) {
    work(0, count);
    return;
  }
  std::vector<std::thread> threads;
  int64_t chunk = (count + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = lo + chunk < count ? lo + chunk : count;
    if (lo >= hi) break;
    threads.emplace_back(work, lo, hi);
  }
  for (auto& th : threads) th.join();
}

// Writer: create a store file from contiguous buffers.
int r2l_write(const char* path, uint64_t n, uint64_t h, uint64_t w,
              uint64_t c, uint64_t dtype, uint64_t label_kind,
              const void* data, const void* labels) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  Header hdr{kMagic, n, h, w, c, dtype, label_kind};
  uint64_t cc = c ? c : 1;
  size_t item_bytes = h * w * cc * dtype_size(dtype);
  size_t label_bytes = label_kind == 0 ? 8 : h * w * 4;
  int ok = fwrite(&hdr, sizeof(hdr), 1, f) == 1 &&
           fwrite(data, item_bytes, n, f) == n &&
           fwrite(labels, label_bytes, n, f) == n;
  fclose(f);
  return ok ? 0 : -2;
}

}  // extern "C"
