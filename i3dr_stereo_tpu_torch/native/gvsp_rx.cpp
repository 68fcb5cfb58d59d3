// Native GVSP reassembly engine — the wire-rate hot loop of the GigE
// driver (io/gige.py). The Python GVSPReceiver is the REFERENCE
// implementation (readable, fully featured, loss/reorder-tested); at the
// real operating point — two 5 MP cameras, SCPS 2996, ~17k packets/s per
// camera (launch/stereo_capture.launch:14-23) — Python reassembly costs
// ~90 ms CPU per frame and tops out below the required 2x5 FPS, so this
// file re-implements only the per-packet path in C++:
//
//   recvfrom -> 8-byte GVSP header parse -> payload memcpy into the
//   frame slot at (packet_id-1)*payload_size -> bitmap bookkeeping
//
// in a dedicated thread that never touches the GIL. Control-plane work
// (GVCP, PACKETRESEND issue, heartbeat) stays in Python: the engine
// exposes missing-run polling (gvsp_rx_poll_missing) so the Python
// side can fire resends over its GVCP client, and completed frames are
// popped from a small slot ring (gvsp_rx_poll_frame).
//
// Reassembly semantics match io/gige.py GVSPReceiver: blocks complete
// when leader + trailer + all payload ids [1, trailer_id-1] are
// present; payload size is learned as the max body length seen (all
// non-final payloads are equal-sized by protocol — if the learned size
// ever GROWS after writes, the block is invalidated and dropped, a
// pathological ordering the tests never produce); stale blocks age out
// after a TTL; per-block resend rounds are budgeted. Built on demand
// with g++ (see native/shm.py pattern), bound via ctypes.

#include <arpa/inet.h>
#include <cstring>
#include <cstdint>
#include <cstdlib>
#include <mutex>
#include <netinet/in.h>
#include <sys/socket.h>
#include <sys/time.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

constexpr int kMaxPkts = 8192;      // per block (5 MP @ SCPS 1500 ~ 3500)
constexpr uint8_t FMT_LEADER = 0x01;
constexpr uint8_t FMT_TRAILER = 0x02;
constexpr uint8_t FMT_PAYLOAD = 0x03;

double now_s() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return ts.tv_sec + 1e-9 * ts.tv_nsec;
}

struct Block {
  bool used = false;
  bool invalid = false;
  uint16_t block_id = 0;
  bool have_leader = false;
  bool have_trailer = false;
  uint32_t trailer_id = 0;
  uint64_t timestamp = 0;
  uint32_t pixfmt = 0, width = 0, height = 0;
  uint32_t payload_size = 0;        // learned max body size
  uint32_t n_received = 0;
  uint32_t resend_rounds = 0;
  double created = 0, last_update = 0, last_request = 0;
  int slot = -1;                    // frame buffer slot
  std::vector<uint64_t> bitmap;     // payload ids seen (1-based)
  std::vector<uint32_t> lens;       // per-payload body length

  void reset() {
    used = invalid = have_leader = have_trailer = false;
    trailer_id = payload_size = n_received = resend_rounds = 0;
    slot = -1;
    std::fill(bitmap.begin(), bitmap.end(), 0);
  }
  bool seen(uint32_t pid) const {
    return pid < kMaxPkts && (bitmap[pid >> 6] >> (pid & 63)) & 1;
  }
  void mark(uint32_t pid) { bitmap[pid >> 6] |= 1ull << (pid & 63); }
};

struct Slot {
  std::vector<uint8_t> data;
  uint64_t timestamp = 0;
  uint16_t block_id = 0;
  uint32_t width = 0, height = 0, bpp = 8;
  uint32_t nbytes = 0;
  uint32_t rounds = 0;
  double received = 0;              // host time of the block's 1st packet
};

struct Rx {
  int fd = -1;
  uint16_t port = 0;
  std::thread thr;
  volatile bool stop = false;
  std::mutex mu;

  std::vector<Block> blocks;   // in-flight (incomplete) blocks
  std::vector<Slot> slots;          // frame buffers
  std::vector<int> free_slots;
  std::vector<int> done;            // completed slot indices (FIFO)

  double block_ttl = 2.0;
  uint32_t max_resend_rounds = 4;
  double last_rx = 0;
  double popped_received = 0;       // of the frame last popped

  // stats
  uint64_t packets = 0, frames = 0, dropped = 0, resend_runs = 0,
           recovered = 0, invalidated = 0;

  // ids of the blocks completed last: a stray packet of one of them (a
  // duplicate, a late resend) is dropped, where a new entry for it could
  // evict a block still filling
  static constexpr int kRecent = 16;
  uint16_t recent[kRecent] = {};
  int n_recent = 0, recent_pos = 0;

  bool completed_recently(uint16_t bid) const {
    for (int i = 0; i < n_recent; i++)
      if (recent[i] == bid) return true;
    return false;
  }

  // the block's entry, a new one where it has none (evicting the oldest
  // incomplete block when every entry is in use), or nullptr for a stray
  // packet of a block completed recently
  Block* find(uint16_t bid, double now) {
    Block* oldest = nullptr;
    for (auto& b : blocks)
      if (b.used && b.block_id == bid) return &b;
    if (completed_recently(bid)) return nullptr;
    for (auto& b : blocks) {
      if (!b.used) { oldest = &b; break; }
      if (!oldest || b.created < oldest->created) oldest = &b;
    }
    if (oldest->used) {             // evict the oldest incomplete
      release(*oldest, false);
    }
    oldest->reset();
    oldest->used = true;
    oldest->block_id = bid;
    oldest->created = oldest->last_update = now;
    if (!free_slots.empty()) {
      oldest->slot = free_slots.back();
      free_slots.pop_back();
    }
    return oldest;
  }

  void release(Block& b, bool completed) {
    if (!completed && b.slot >= 0) free_slots.push_back(b.slot);
    if (!completed) dropped++;
    b.used = false;
    b.slot = -1;
  }

  void try_finish(Block& b) {
    if (!b.have_leader || !b.have_trailer || b.invalid || b.slot < 0)
      return;
    if (b.trailer_id < 2) {             // no payloads: nothing to deliver
      release(b, false);
      return;
    }
    uint32_t n_payload = b.trailer_id - 1;
    if (b.n_received < n_payload) return;
    for (uint32_t p = 1; p <= n_payload; p++)
      if (!b.seen(p)) return;
    Slot& s = slots[b.slot];
    s.timestamp = b.timestamp;
    s.block_id = b.block_id;
    s.width = b.width;
    s.height = b.height;
    s.bpp = (b.pixfmt >> 16) & 0xFF;
    uint32_t need = s.width * s.height * (s.bpp > 8 ? 2 : 1);
    // total bytes actually received
    uint64_t got = uint64_t(n_payload - 1) * b.payload_size + b.lens[n_payload];
    if (got < need || need > s.data.size()) {
      release(b, false);
      return;
    }
    s.nbytes = need;
    s.rounds = b.resend_rounds;
    s.received = b.created;
    frames++;
    if (b.resend_rounds) recovered++;
    done.push_back(b.slot);
    recent[recent_pos] = b.block_id;
    recent_pos = (recent_pos + 1) % kRecent;
    if (n_recent < kRecent) n_recent++;
    b.slot = -1;
    release(b, true);
  }

  void loop() {
    std::vector<uint8_t> buf(65536);
    while (!stop) {
      ssize_t n = recv(fd, buf.data(), buf.size(), 0);
      if (n < 0) continue;          // timeout / EINTR
      if (n < 8) continue;
      double now = now_s();
      uint16_t bid = (uint16_t(buf[2]) << 8) | buf[3];
      uint32_t word = (uint32_t(buf[4]) << 24) | (uint32_t(buf[5]) << 16) |
                      (uint32_t(buf[6]) << 8) | buf[7];
      uint8_t fmt = word >> 24;
      uint32_t pid = word & 0xFFFFFF;
      const uint8_t* body = buf.data() + 8;
      uint32_t blen = uint32_t(n) - 8;

      std::lock_guard<std::mutex> lk(mu);
      last_rx = now;
      packets++;
      Block* b = find(bid, now);
      if (!b) continue;             // a stray of a completed block
      b->last_update = now;
      if (fmt == FMT_LEADER) {
        if (blen >= 24) {
          b->have_leader = true;
          uint64_t ts = 0;
          for (int i = 0; i < 8; i++) ts = (ts << 8) | body[4 + i];
          b->timestamp = ts;
          b->pixfmt = (uint32_t(body[12]) << 24) | (uint32_t(body[13]) << 16) |
                      (uint32_t(body[14]) << 8) | body[15];
          b->width = (uint32_t(body[16]) << 24) | (uint32_t(body[17]) << 16) |
                     (uint32_t(body[18]) << 8) | body[19];
          b->height = (uint32_t(body[20]) << 24) | (uint32_t(body[21]) << 16) |
                      (uint32_t(body[22]) << 8) | body[23];
        }
      } else if (fmt == FMT_PAYLOAD) {
        if (pid == 0 || pid >= kMaxPkts || b->seen(pid)) { try_finish(*b); continue; }
        if (blen > b->payload_size) {
          if (b->n_received > 0 && b->payload_size > 0) {
            // learned size grew after offsets were committed: the first
            // packet seen was the short FINAL payload (pathological
            // reordering) — invalidate rather than mis-place bytes
            b->invalid = true;
            invalidated++;
            release(*b, false);
            continue;
          }
          b->payload_size = blen;
        }
        if (b->slot >= 0) {
          Slot& s = slots[b->slot];
          uint64_t off = uint64_t(pid - 1) * b->payload_size;
          if (off + blen <= s.data.size()) {
            memcpy(s.data.data() + off, body, blen);
            b->mark(pid);
            b->lens[pid] = blen;
            b->n_received++;
          }
        }
      } else if (fmt == FMT_TRAILER) {
        if (pid >= 1 && pid <= kMaxPkts) {  // trailer id may be kMaxPkts:
          // payload pids are < kMaxPkts, so lens[pid-1]/seen(p<=pid-1)
          // stay in range
          b->have_trailer = true;
          b->trailer_id = pid;
        }
      }
      try_finish(*b);
    }
  }
};

}  // namespace

extern "C" {

void* gvsp_rx_create(uint16_t* port_out, int recv_buf, int max_frame_bytes,
                     int nslots, double block_ttl, int max_resend_rounds) {
  Rx* rx = new Rx();
  rx->block_ttl = block_ttl > 0 ? block_ttl : 2.0;
  rx->max_resend_rounds = max_resend_rounds >= 0 ? max_resend_rounds : 4;
  rx->fd = socket(AF_INET, SOCK_DGRAM, 0);
  if (rx->fd < 0) { delete rx; return nullptr; }
  setsockopt(rx->fd, SOL_SOCKET, SO_RCVBUF, &recv_buf, sizeof(recv_buf));
  struct timeval tv { 0, 50000 };   // 50 ms recv tick for clean shutdown
  setsockopt(rx->fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_ANY);
  addr.sin_port = 0;
  if (bind(rx->fd, (sockaddr*)&addr, sizeof(addr)) != 0) {
    close(rx->fd); delete rx; return nullptr;
  }
  socklen_t alen = sizeof(addr);
  getsockname(rx->fd, (sockaddr*)&addr, &alen);
  rx->port = ntohs(addr.sin_port);
  if (port_out) *port_out = rx->port;

  rx->slots.resize(nslots);
  for (int i = 0; i < nslots; i++) {
    rx->slots[i].data.resize(max_frame_bytes);
    rx->free_slots.push_back(i);
  }
  rx->blocks.resize(nslots + 8);
  for (auto& b : rx->blocks) {
    b.bitmap.resize((kMaxPkts + 63) / 64, 0);
    b.lens.resize(kMaxPkts, 0);
  }
  rx->thr = std::thread([rx] { rx->loop(); });
  return rx;
}

// Pop one completed frame. Returns 1 and fills outputs, or 0 if none.
int gvsp_rx_poll_frame(void* h, double* stamp, uint64_t* seq, void* buf,
                       uint32_t cap, uint32_t* w, uint32_t* hgt,
                       uint32_t* bpp) {
  Rx* rx = (Rx*)h;
  std::lock_guard<std::mutex> lk(rx->mu);
  if (rx->done.empty()) return 0;
  int si = rx->done.front();
  Slot& s = rx->slots[si];
  if (s.nbytes > cap) return -1;    // caller buffer too small
  rx->done.erase(rx->done.begin());
  memcpy(buf, s.data.data(), s.nbytes);
  if (stamp) *stamp = double(s.timestamp) / 1e9;
  if (seq) *seq = s.block_id;
  if (w) *w = s.width;
  if (hgt) *hgt = s.height;
  if (bpp) *bpp = s.bpp;
  rx->popped_received = s.received;
  rx->free_slots.push_back(si);
  return 1;
}

// Missing-run query for PACKETRESEND: scans for ONE stalled block
// (idle > min_idle_s, or trailer present but incomplete), emits up to
// max_runs (first,last) pairs into runs[], bumps its resend round.
// Returns run count (block id in *block_id); 0 if nothing to service.
// TTL-expired / budget-exhausted blocks are dropped here.
int gvsp_rx_poll_missing(void* h, double min_idle_s, uint32_t* block_id,
                         uint32_t* runs, int max_runs) {
  Rx* rx = (Rx*)h;
  double now = now_s();
  std::lock_guard<std::mutex> lk(rx->mu);
  for (auto& b : rx->blocks) {
    if (!b.used) continue;
    if (now - b.created > rx->block_ttl) { rx->release(b, false); continue; }
    bool stalled = (now - b.last_update >= min_idle_s) ||
                   (b.have_trailer && b.trailer_id > 0);
    if (!stalled || now - b.last_request < min_idle_s) continue;
    if (max_runs <= 0) {
      // no resend path: a stalled block can only be dropped (what the
      // Python receiver does when resend is None)
      rx->release(b, false);
      continue;
    }
    if (b.resend_rounds >= rx->max_resend_rounds) {
      rx->release(b, false);
      continue;
    }
    // expected last packet id
    uint32_t last = 0;
    if (b.have_trailer) last = b.trailer_id;
    else if (b.have_leader && b.payload_size > 0) {
      uint64_t need = uint64_t(b.width) * b.height *
                      (((b.pixfmt >> 16) & 0xFF) > 8 ? 2 : 1);
      last = uint32_t((need + b.payload_size - 1) / b.payload_size) + 1;
    } else {
      // geometry unknown: ask for the leader
      if (max_runs >= 1) { runs[0] = 0; runs[1] = 0; }
      *block_id = b.block_id;
      b.resend_rounds++;
      b.last_request = now;
      rx->resend_runs++;
      return 1;
    }
    int nr = 0;
    int32_t run_start = -1;
    for (uint32_t p = b.have_leader ? 1 : 0; p <= last && nr < max_runs; p++) {
      bool missing = (p == 0) ? !b.have_leader
                   : (p == last) ? !b.have_trailer
                   : !b.seen(p);
      if (missing && run_start < 0) run_start = p;
      if ((!missing || p == last) && run_start >= 0) {
        uint32_t run_end = missing ? p : p - 1;
        runs[2 * nr] = run_start;
        runs[2 * nr + 1] = run_end;
        nr++;
        run_start = -1;
      }
    }
    if (nr == 0) continue;
    *block_id = b.block_id;
    b.resend_rounds++;
    b.last_request = now;
    rx->resend_runs++;
    return nr;
  }
  return 0;
}

uint16_t gvsp_rx_port(void* h) { return ((Rx*)h)->port; }

// stats[0..6] = packets, frames, dropped, resend_runs, recovered,
//               pending_blocks, invalidated
void gvsp_rx_stats(void* h, uint64_t* out) {
  Rx* rx = (Rx*)h;
  std::lock_guard<std::mutex> lk(rx->mu);
  uint64_t pending = 0;
  for (auto& b : rx->blocks) pending += b.used ? 1 : 0;
  out[0] = rx->packets;
  out[1] = rx->frames;
  out[2] = rx->dropped;
  out[3] = rx->resend_runs;
  out[4] = rx->recovered;
  out[5] = pending;
  out[6] = rx->invalidated;
}

double gvsp_rx_last_rx(void* h) {
  Rx* rx = (Rx*)h;
  std::lock_guard<std::mutex> lk(rx->mu);
  return rx->last_rx > 0 ? now_s() - rx->last_rx : -1.0;
}

// Host monotonic time (s) at which the first packet of the frame last
// popped arrived.
double gvsp_rx_popped_received(void* h) {
  Rx* rx = (Rx*)h;
  std::lock_guard<std::mutex> lk(rx->mu);
  return rx->popped_received;
}

void gvsp_rx_close(void* h) {
  Rx* rx = (Rx*)h;
  rx->stop = true;
  if (rx->thr.joinable()) rx->thr.join();
  close(rx->fd);
  delete rx;
}

}  // extern "C"
