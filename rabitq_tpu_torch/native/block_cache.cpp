// Host runtime pieces of rabitq_tpu_torch, C ABI for ctypes (the port's
// copy of rabitq_tpu/native/block_cache.cpp; same entry points).
//
// 1. Thread-safe LRU block cache: the in-process layer of the store
//    tier's block cache (store/vector_store.py BlockCachedStore); SQLite
//    stays the cross-process layer.
// 2. Single-pass fvecs parser: validates uniform record dims and strips
//    the headers in one scan.
//
// Built at first use by rabitq_tpu_torch/native/__init__.py
// (g++ -O3 -std=c++17 -fPIC -shared).

#include <cstdint>
#include <cstring>
#include <list>
#include <mutex>
#include <unordered_map>
#include <vector>

namespace {

struct Entry {
  std::vector<float> data;
  std::list<int64_t>::iterator lru_it;
};

struct Cache {
  size_t max_blocks;
  std::mutex mu;
  std::unordered_map<int64_t, Entry> map;
  std::list<int64_t> lru;  // front = most recent

  explicit Cache(size_t max) : max_blocks(max == 0 ? 1 : max) {}
};

}  // namespace

extern "C" {

void* rbq_cache_new(size_t max_blocks) { return new Cache(max_blocks); }

void rbq_cache_free(void* h) { delete static_cast<Cache*>(h); }

// Returns the number of floats copied into `out` (capacity `cap`), or -1 on
// miss / insufficient capacity.
int64_t rbq_cache_get(void* h, int64_t id, float* out, size_t cap) {
  Cache* c = static_cast<Cache*>(h);
  std::lock_guard<std::mutex> lock(c->mu);
  auto it = c->map.find(id);
  if (it == c->map.end()) return -1;
  const std::vector<float>& v = it->second.data;
  if (v.size() > cap) return -1;
  std::memcpy(out, v.data(), v.size() * sizeof(float));
  c->lru.erase(it->second.lru_it);
  c->lru.push_front(id);
  it->second.lru_it = c->lru.begin();
  return static_cast<int64_t>(v.size());
}

void rbq_cache_put(void* h, int64_t id, const float* data, size_t n) {
  Cache* c = static_cast<Cache*>(h);
  std::lock_guard<std::mutex> lock(c->mu);
  auto it = c->map.find(id);
  if (it != c->map.end()) {
    it->second.data.assign(data, data + n);
    c->lru.erase(it->second.lru_it);
    c->lru.push_front(id);
    it->second.lru_it = c->lru.begin();
    return;
  }
  while (c->map.size() >= c->max_blocks) {
    int64_t victim = c->lru.back();
    c->lru.pop_back();
    c->map.erase(victim);
  }
  c->lru.push_front(id);
  Entry e;
  e.data.assign(data, data + n);
  e.lru_it = c->lru.begin();
  c->map.emplace(id, std::move(e));
}

size_t rbq_cache_size(void* h) {
  Cache* c = static_cast<Cache*>(h);
  std::lock_guard<std::mutex> lock(c->mu);
  return c->map.size();
}

// Parse a uniform-dimension vecs buffer: records of [u32 dim][dim * 4B].
// Writes payload rows into `out` (capacity `out_cap` u32 words). Returns the
// number of records parsed, or -1 (corrupt/ragged) / -2 (capacity).
int64_t rbq_vecs_parse(const uint8_t* buf, size_t nbytes, uint32_t* out,
                       size_t out_cap, uint32_t* dim_out) {
  if (nbytes < 4) {
    *dim_out = 0;
    return 0;
  }
  uint32_t dim;
  std::memcpy(&dim, buf, 4);
  *dim_out = dim;
  if (dim == 0) return -1;
  const size_t stride = 4 * (static_cast<size_t>(dim) + 1);
  if (nbytes % stride != 0) return -1;
  const size_t n = nbytes / stride;
  if (n * dim > out_cap) return -2;
  for (size_t i = 0; i < n; ++i) {
    const uint8_t* rec = buf + i * stride;
    uint32_t d;
    std::memcpy(&d, rec, 4);
    if (d != dim) return -1;
    std::memcpy(out + i * dim, rec + 4, 4 * static_cast<size_t>(dim));
  }
  return static_cast<int64_t>(n);
}

}  // extern "C"
