// Native host runtime primitives for the columnar engine (a copy of
// spark_rapids_tpu/memory/native/runtime.cpp, with <cstdlib> included
// for std::malloc/std::free, which newer libstdc++ headers no longer
// bring in through <map>).
//
// The reference keeps its native code in external deps (cuDF/RMM); its
// in-JVM memory bookkeeping lives in AddressSpaceAllocator.scala (first-fit
// address-space allocator carving the pinned/host pool) and
// HashedPriorityQueue.java (O(log n) priority queue with O(1) containment
// for spill-priority tracking).  This library provides the same two
// primitives as C++ with a C ABI, loaded from Python via ctypes
// (spark_rapids_tpu_torch/memory/native/__init__.py).
//
// Build (done at first use by that loader):
//   g++ -O2 -std=c++17 -shared -fPIC -o libruntime.so runtime.cpp
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <map>
#include <mutex>
#include <unordered_map>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Address-space allocator: first-fit over [0, size) with block splitting and
// free-neighbour coalescing (reference AddressSpaceAllocator.scala behavior).
struct AsaBlock {
  uint64_t size;
  bool free;
};

struct Asa {
  // offset -> block; ordered so neighbours coalesce in O(log n)
  std::map<uint64_t, AsaBlock> blocks;
  uint64_t total;
  uint64_t allocated;
  std::mutex mu;
};

void* asa_create(uint64_t size) {
  Asa* a = new Asa();
  a->total = size;
  a->allocated = 0;
  a->blocks[0] = AsaBlock{size, true};
  return a;
}

void asa_destroy(void* h) { delete static_cast<Asa*>(h); }

// Returns the offset of the allocation, or UINT64_MAX when it does not fit.
uint64_t asa_allocate(void* h, uint64_t size) {
  Asa* a = static_cast<Asa*>(h);
  std::lock_guard<std::mutex> lk(a->mu);
  if (size == 0) size = 1;
  for (auto it = a->blocks.begin(); it != a->blocks.end(); ++it) {
    if (!it->second.free || it->second.size < size) continue;
    uint64_t off = it->first;
    uint64_t remain = it->second.size - size;
    it->second.size = size;
    it->second.free = false;
    if (remain > 0) a->blocks[off + size] = AsaBlock{remain, true};
    a->allocated += size;
    return off;
  }
  return UINT64_MAX;
}

// Frees the block at `offset`; returns its size, or UINT64_MAX if unknown.
uint64_t asa_free(void* h, uint64_t offset) {
  Asa* a = static_cast<Asa*>(h);
  std::lock_guard<std::mutex> lk(a->mu);
  auto it = a->blocks.find(offset);
  if (it == a->blocks.end() || it->second.free) return UINT64_MAX;
  uint64_t size = it->second.size;
  it->second.free = true;
  a->allocated -= size;
  // coalesce with next
  auto nx = std::next(it);
  if (nx != a->blocks.end() && nx->second.free) {
    it->second.size += nx->second.size;
    a->blocks.erase(nx);
  }
  // coalesce with prev
  if (it != a->blocks.begin()) {
    auto pv = std::prev(it);
    if (pv->second.free) {
      pv->second.size += it->second.size;
      a->blocks.erase(it);
    }
  }
  return size;
}

uint64_t asa_allocated(void* h) {
  Asa* a = static_cast<Asa*>(h);
  std::lock_guard<std::mutex> lk(a->mu);
  return a->allocated;
}

uint64_t asa_available(void* h) {
  Asa* a = static_cast<Asa*>(h);
  std::lock_guard<std::mutex> lk(a->mu);
  return a->total - a->allocated;
}

// Largest free block — how big an allocation could currently succeed.
uint64_t asa_largest_free(void* h) {
  Asa* a = static_cast<Asa*>(h);
  std::lock_guard<std::mutex> lk(a->mu);
  uint64_t best = 0;
  for (auto& kv : a->blocks)
    if (kv.second.free && kv.second.size > best) best = kv.second.size;
  return best;
}

// ---------------------------------------------------------------------------
// Hashed priority queue keyed by int64 id with double priority; lowest
// priority polls first (spill candidates).  FIFO tie-break via sequence
// number, like the reference's insertion-ordered comparator behavior.
struct Hpq {
  // (priority, seq) -> id
  std::map<std::pair<double, uint64_t>, int64_t> q;
  std::unordered_map<int64_t, std::pair<double, uint64_t>> pos;
  uint64_t seq = 0;
  std::mutex mu;
};

void* hpq_create() { return new Hpq(); }
void hpq_destroy(void* h) { delete static_cast<Hpq*>(h); }

void hpq_offer(void* h, int64_t id, double priority) {
  Hpq* p = static_cast<Hpq*>(h);
  std::lock_guard<std::mutex> lk(p->mu);
  auto it = p->pos.find(id);
  if (it != p->pos.end()) p->q.erase(it->second);
  auto key = std::make_pair(priority, p->seq++);
  p->q[key] = id;
  p->pos[id] = key;
}

// Pops the lowest-priority element; INT64_MIN when empty.
int64_t hpq_poll(void* h) {
  Hpq* p = static_cast<Hpq*>(h);
  std::lock_guard<std::mutex> lk(p->mu);
  if (p->q.empty()) return INT64_MIN;
  auto it = p->q.begin();
  int64_t id = it->second;
  p->pos.erase(id);
  p->q.erase(it);
  return id;
}

int64_t hpq_peek(void* h) {
  Hpq* p = static_cast<Hpq*>(h);
  std::lock_guard<std::mutex> lk(p->mu);
  if (p->q.empty()) return INT64_MIN;
  return p->q.begin()->second;
}

// 1 if removed, 0 if absent.
int hpq_remove(void* h, int64_t id) {
  Hpq* p = static_cast<Hpq*>(h);
  std::lock_guard<std::mutex> lk(p->mu);
  auto it = p->pos.find(id);
  if (it == p->pos.end()) return 0;
  p->q.erase(it->second);
  p->pos.erase(it);
  return 1;
}

int hpq_contains(void* h, int64_t id) {
  Hpq* p = static_cast<Hpq*>(h);
  std::lock_guard<std::mutex> lk(p->mu);
  return p->pos.count(id) ? 1 : 0;
}

void hpq_update_priority(void* h, int64_t id, double priority) {
  hpq_remove(h, id);
  hpq_offer(h, id, priority);
}

uint64_t hpq_size(void* h) {
  Hpq* p = static_cast<Hpq*>(h);
  std::lock_guard<std::mutex> lk(p->mu);
  return p->q.size();
}

// ---------------------------------------------------------------------------
// Pinned-staging arena: one big malloc'd host buffer the Python side reads /
// writes through memoryviews (the PinnedMemoryPool analog — page-locked DMA
// staging is a TPU-runtime concern; here we provide the pool carving +
// stable addresses the stores need).
void* arena_create(uint64_t size) { return std::malloc(size); }
void arena_destroy(void* p) { std::free(p); }
void arena_write(void* p, uint64_t off, const uint8_t* src, uint64_t n) {
  std::memcpy(static_cast<uint8_t*>(p) + off, src, n);
}
void arena_read(void* p, uint64_t off, uint8_t* dst, uint64_t n) {
  std::memcpy(dst, static_cast<uint8_t*>(p) + off, n);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Spill-file IO with integrity framing (the role the JVM's checksummed
// shuffle/spill writers play; cuDF-side buffers get this from the
// filesystem layer in the reference).  Format:
//   magic "TPUS" | u32 version | u64 payload_len | u32 crc32 | payload
// Header integers are host-endian; the engine's supported hosts (x86,
// ARM) are little-endian, matching the Python fallback's "<IQI". A
// big-endian port would need explicit LE writes here.
// Written with fsync so a spilled buffer survives a crash of the
// executor process; read verifies length + CRC and reports corruption
// instead of handing poisoned bytes to the engine.
#include <cstdio>
#if defined(__unix__) || defined(__APPLE__)
#include <unistd.h>
#endif

extern "C" {

// C++11 magic-static init: thread-safe even when ctypes calls arrive
// concurrently with the GIL released
static const uint32_t* crc32_table_get() {
  static const uint32_t* table = [] {
    static uint32_t t[256];
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i;
      for (int k = 0; k < 8; k++)
        c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      t[i] = c;
    }
    return t;
  }();
  return table;
}

uint32_t rt_crc32(const uint8_t* data, uint64_t n) {
  const uint32_t* table = crc32_table_get();
  uint32_t c = 0xFFFFFFFFu;
  for (uint64_t i = 0; i < n; i++)
    c = table[(c ^ data[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

static const char kSpillMagic[4] = {'T', 'P', 'U', 'S'};
static const uint32_t kSpillVersion = 1;

// returns 0 on success, negative errno-style codes on failure
int64_t spill_write(const char* path, const uint8_t* data, uint64_t n) {
  std::FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  uint32_t crc = rt_crc32(data, n);
  bool ok = std::fwrite(kSpillMagic, 1, 4, f) == 4 &&
            std::fwrite(&kSpillVersion, 4, 1, f) == 1 &&
            std::fwrite(&n, 8, 1, f) == 1 &&
            std::fwrite(&crc, 4, 1, f) == 1 &&
            (n == 0 || std::fwrite(data, 1, n, f) == n);
  if (ok) ok = std::fflush(f) == 0;
#if defined(__unix__) || defined(__APPLE__)
  if (ok) ok = fsync(fileno(f)) == 0;
#endif
  std::fclose(f);
  return ok ? 0 : -2;
}

// returns payload length, or negative code: -1 open, -2 header,
// -3 bad magic/version, -4 size mismatch, -5 crc mismatch
int64_t spill_read_size(const char* path) {
  std::FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  char magic[4];
  uint32_t version, crc;
  uint64_t n;
  bool ok = std::fread(magic, 1, 4, f) == 4 &&
            std::fread(&version, 4, 1, f) == 1 &&
            std::fread(&n, 8, 1, f) == 1 &&
            std::fread(&crc, 4, 1, f) == 1;
  // 64-bit tell: long is 32-bit on LLP64 (Windows), so >2GB spill
  // files would misreport size through std::ftell (ADVICE r1)
#if defined(_WIN32)
  int64_t hdr_end = ok ? _ftelli64(f) : 0;
  int64_t file_end = 0;
  if (ok && _fseeki64(f, 0, SEEK_END) == 0) file_end = _ftelli64(f);
#else
  int64_t hdr_end = ok ? static_cast<int64_t>(ftello(f)) : 0;
  int64_t file_end = 0;
  if (ok && fseeko(f, 0, SEEK_END) == 0)
    file_end = static_cast<int64_t>(ftello(f));
#endif
  std::fclose(f);
  if (!ok) return -2;
  if (std::memcmp(magic, kSpillMagic, 4) != 0 || version != kSpillVersion)
    return -3;
  // a corrupted length field must not escape as a huge allocation
  if (file_end - hdr_end != static_cast<int64_t>(n)) return -4;
  return static_cast<int64_t>(n);
}

int64_t spill_read(const char* path, uint8_t* out, uint64_t out_len) {
  std::FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  char magic[4];
  uint32_t version, crc;
  uint64_t n;
  bool ok = std::fread(magic, 1, 4, f) == 4 &&
            std::fread(&version, 4, 1, f) == 1 &&
            std::fread(&n, 8, 1, f) == 1 &&
            std::fread(&crc, 4, 1, f) == 1;
  if (!ok) { std::fclose(f); return -2; }
  if (std::memcmp(magic, kSpillMagic, 4) != 0 ||
      version != kSpillVersion) { std::fclose(f); return -3; }
  if (n != out_len) { std::fclose(f); return -4; }
  ok = (n == 0) || std::fread(out, 1, n, f) == n;
  std::fclose(f);
  if (!ok) return -4;
  if (rt_crc32(out, n) != crc) return -5;
  return static_cast<int64_t>(n);
}

}  // extern "C"
