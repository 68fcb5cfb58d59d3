// Shared-memory frame ring buffer + stamp pairer (host runtime).
//
// TPU-native replacement for the reference's capture transport: the
// GStreamer `shmsink socket-path=/tmp/ros_mem_<serial>` segment between
// the camera pipeline and gscam (tiscamera.py:70-77) plus the TCPROS hop
// into the matcher process. Here a camera driver process pushes frames
// into a single-producer/single-consumer ring in POSIX shared memory and
// the pipeline host pops them zero-copy (numpy frombuffer -> device_put).
//
// A small C API (ctypes-friendly) — no Python.h dependency:
//   i3dr_ring_create(name, slots, frame_bytes)      -> handle
//   i3dr_ring_open(name)                            -> handle
//   i3dr_ring_push(h, stamp, seq, data, n)          -> 1 ok / 0 full
//   i3dr_ring_pop(h, &stamp, &seq, data, n)         -> 1 ok / 0 empty
//   i3dr_ring_peek_stamp(h, &stamp)                 -> 1 ok / 0 empty
//   i3dr_ring_drop(h)                               -> 1 ok / 0 empty
//   i3dr_ring_size(h) / i3dr_ring_capacity(h) / i3dr_ring_frame_bytes(h)
//   i3dr_ring_close(h) / i3dr_ring_unlink(name)
//
// Pairing (the ApproximateTime policy for two streams, matching
// generate_disparity.cpp:68-70 semantics for the 2-image case):
//   i3dr_pair_pop(hl, hr, slop, stamp*, seq*, ldata, rdata, n) ->
//       1 pair ready / 0 none (drops stale unmatched frames).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <cstdio>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMagic = 0x49334452524e4731ull;  // "I3DRRNG1"

struct RingHeader {
  uint64_t magic;
  uint32_t slots;
  uint32_t frame_bytes;
  std::atomic<uint64_t> head;  // next write index (producer)
  std::atomic<uint64_t> tail;  // next read index (consumer)
};

struct SlotHeader {
  double stamp;
  uint64_t seq;
};

struct Ring {
  RingHeader* hdr;
  uint8_t* slots;
  size_t map_bytes;
  int fd;
};

size_t slot_stride(uint32_t frame_bytes) {
  size_t s = sizeof(SlotHeader) + frame_bytes;
  return (s + 63) & ~size_t(63);  // cache-line align
}

uint8_t* slot_ptr(Ring* r, uint64_t idx) {
  return r->slots + slot_stride(r->hdr->frame_bytes) * (idx % r->hdr->slots);
}

}  // namespace

extern "C" {

void* i3dr_ring_create(const char* name, uint32_t slots, uint32_t frame_bytes) {
  size_t bytes = sizeof(RingHeader) + slot_stride(frame_bytes) * slots;
  int fd = shm_open(name, O_CREAT | O_RDWR, 0600);
  if (fd < 0) return nullptr;
  if (ftruncate(fd, (off_t)bytes) != 0) { close(fd); return nullptr; }
  void* mem = mmap(nullptr, bytes, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  if (mem == MAP_FAILED) { close(fd); return nullptr; }
  Ring* r = new Ring;
  r->hdr = (RingHeader*)mem;
  r->slots = (uint8_t*)mem + sizeof(RingHeader);
  r->map_bytes = bytes;
  r->fd = fd;
  r->hdr->magic = kMagic;
  r->hdr->slots = slots;
  r->hdr->frame_bytes = frame_bytes;
  r->hdr->head.store(0);
  r->hdr->tail.store(0);
  return r;
}

void* i3dr_ring_open(const char* name) {
  int fd = shm_open(name, O_RDWR, 0600);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) { close(fd); return nullptr; }
  void* mem = mmap(nullptr, st.st_size, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  if (mem == MAP_FAILED) { close(fd); return nullptr; }
  RingHeader* h = (RingHeader*)mem;
  if (h->magic != kMagic) { munmap(mem, st.st_size); close(fd); return nullptr; }
  Ring* r = new Ring;
  r->hdr = h;
  r->slots = (uint8_t*)mem + sizeof(RingHeader);
  r->map_bytes = st.st_size;
  r->fd = fd;
  return r;
}

int i3dr_ring_push(void* handle, double stamp, uint64_t seq,
                   const uint8_t* data, uint32_t n) {
  Ring* r = (Ring*)handle;
  if (n > r->hdr->frame_bytes) return 0;
  uint64_t head = r->hdr->head.load(std::memory_order_relaxed);
  uint64_t tail = r->hdr->tail.load(std::memory_order_acquire);
  if (head - tail >= r->hdr->slots) return 0;  // full
  uint8_t* p = slot_ptr(r, head);
  SlotHeader sh{stamp, seq};
  std::memcpy(p, &sh, sizeof(sh));
  std::memcpy(p + sizeof(sh), data, n);
  r->hdr->head.store(head + 1, std::memory_order_release);
  return 1;
}

int i3dr_ring_pop(void* handle, double* stamp, uint64_t* seq,
                  uint8_t* data, uint32_t n) {
  Ring* r = (Ring*)handle;
  uint64_t tail = r->hdr->tail.load(std::memory_order_relaxed);
  uint64_t head = r->hdr->head.load(std::memory_order_acquire);
  if (tail == head) return 0;  // empty
  uint8_t* p = slot_ptr(r, tail);
  SlotHeader sh;
  std::memcpy(&sh, p, sizeof(sh));
  if (stamp) *stamp = sh.stamp;
  if (seq) *seq = sh.seq;
  uint32_t copy = n < r->hdr->frame_bytes ? n : r->hdr->frame_bytes;
  if (data) std::memcpy(data, p + sizeof(sh), copy);
  r->hdr->tail.store(tail + 1, std::memory_order_release);
  return 1;
}

int i3dr_ring_peek_stamp(void* handle, double* stamp) {
  Ring* r = (Ring*)handle;
  uint64_t tail = r->hdr->tail.load(std::memory_order_relaxed);
  uint64_t head = r->hdr->head.load(std::memory_order_acquire);
  if (tail == head) return 0;
  SlotHeader sh;
  std::memcpy(&sh, slot_ptr(r, tail), sizeof(sh));
  *stamp = sh.stamp;
  return 1;
}

int i3dr_ring_drop(void* handle) {
  Ring* r = (Ring*)handle;
  uint64_t tail = r->hdr->tail.load(std::memory_order_relaxed);
  uint64_t head = r->hdr->head.load(std::memory_order_acquire);
  if (tail == head) return 0;
  r->hdr->tail.store(tail + 1, std::memory_order_release);
  return 1;
}

uint32_t i3dr_ring_size(void* handle) {
  Ring* r = (Ring*)handle;
  return (uint32_t)(r->hdr->head.load() - r->hdr->tail.load());
}

uint32_t i3dr_ring_capacity(void* handle) { return ((Ring*)handle)->hdr->slots; }
uint32_t i3dr_ring_frame_bytes(void* handle) { return ((Ring*)handle)->hdr->frame_bytes; }

void i3dr_ring_close(void* handle) {
  Ring* r = (Ring*)handle;
  munmap((void*)r->hdr, r->map_bytes);
  close(r->fd);
  delete r;
}

int i3dr_ring_unlink(const char* name) { return shm_unlink(name) == 0 ? 1 : 0; }

// --- two-stream ApproximateTime pairing -----------------------------------

int i3dr_pair_pop(void* hl, void* hr, double slop,
                  double* stamp, uint64_t* seq,
                  uint8_t* ldata, uint8_t* rdata, uint32_t n) {
  Ring* L = (Ring*)hl;
  Ring* R = (Ring*)hr;
  for (;;) {
    double sl, sr;
    if (!i3dr_ring_peek_stamp(L, &sl)) return 0;
    if (!i3dr_ring_peek_stamp(R, &sr)) return 0;
    double dt = sl - sr;
    if (dt > slop) {        // right frame stale: drop it, retry
      i3dr_ring_drop(R);
      continue;
    }
    if (dt < -slop) {       // left frame stale
      i3dr_ring_drop(L);
      continue;
    }
    uint64_t sq_l;
    i3dr_ring_pop(L, &sl, &sq_l, ldata, n);
    i3dr_ring_pop(R, &sr, nullptr, rdata, n);
    if (stamp) *stamp = sl < sr ? sl : sr;
    if (seq) *seq = sq_l;
    return 1;
  }
}

}  // extern "C"
