// Host runtime of the PyTorch port: key -> device-slot table, the
// grouped round planner and the whole-mesh plan/decode/commit.
//
// A trimmed copy of the JAX package's native/host_runtime.cpp: the slot
// table (LRU eviction, strict expiry, pending-write refcounts, the
// single-key lookup, eviction count and mapping generation that the
// dataclass path and the GLOBAL sync read, the expiry write and the key
// enumeration of the persistence plane), the grouped planner
// (gt_batch_*), FNV-1/FNV-1a batch hashing and the mesh planner
// (gt_mesh_*), plus bulk forms of the transfer plane's per-key loops
// (gt_mesh_get_slots, gt_mesh_lookup_or_assign, gt_mesh_set_expire),
// and the two-tier mode (a FIFO back table behind the LRU front, with
// queued device moves: gt_table_enable_back .. gt_table_back_keys).
// The JSON/frame parsers, the HTTP edge and the ingress queue are not
// part of the port yet.
// Behaviour on everything kept is the reference's line for line, so a
// port store and a JAX store given the same requests plan the same
// slots, rounds and occurrence indices.
//
// Exposed as a plain C ABI for ctypes.  Thread-safety contract: each
// Table carries its own recursive mutex, taken by every extern-C entry
// that touches it, so batch N+1's planning may run concurrently with
// batch N's decode/commit (models/shard.py ColumnarPipeline).
// Cross-batch ORDERING is the Python tier's job (plan-order tickets +
// the FIFO drain); this mutex only makes each call atomic.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <string>
#include <string_view>
#include <unordered_map>
#include <vector>

namespace {

// FNV-1 / FNV-1a 64: the shard-routing hash (replicated_hash.go:31).
// Single definitions shared by gt_fnv1_batch and the mesh planner so
// shard routing cannot diverge between the two.
inline uint64_t fnv1a64(const char* p, const char* end) {
  uint64_t h = 14695981039346656037ull;
  for (; p < end; ++p) {
    h ^= (uint64_t)(unsigned char)*p;
    h *= 1099511628211ull;
  }
  return h;
}

inline uint64_t fnv1_64(const char* p, const char* end) {
  uint64_t h = 14695981039346656037ull;
  for (; p < end; ++p) {
    h *= 1099511628211ull;
    h ^= (uint64_t)(unsigned char)*p;
  }
  return h;
}

struct Table {
  // Guards every member below against concurrent extern-C calls
  // (recursive: gt_mesh_* entries call gt_batch_* entries on the same
  // table).  See the thread-safety contract at the top of the file.
  std::recursive_mutex mu;
  int64_t capacity;
  // slot -> key (empty string + mapped=false when free)
  std::vector<std::string> slot_key;
  std::vector<uint8_t> slot_mapped;
  std::vector<int64_t> expire_ms;
  // In-flight (planned, not yet committed) device writes per slot.
  // While >0 the device row is fresher than expire_ms, so liveness is
  // device-authoritative — the pipelined twin of the planner's chained
  // lanes (see plan_rounds).  Nonzero only between a columnar batch's
  // plan and its commit.
  std::vector<int32_t> pending_write;
  // LRU intrusive list over slots; head = least recent. -1 = null.
  std::vector<int32_t> lru_prev, lru_next;
  int32_t lru_head = -1, lru_tail = -1;
  std::vector<int32_t> free_slots;  // stack, top = back
  std::unordered_map<std::string, int32_t> key_to_slot;
  int64_t evictions = 0;  // read by the grouped planners
  // Bumped on every key->slot MAPPING change (assign, remap, evict,
  // remove).  NOT bumped by in-place expiry reuse (same key, same slot)
  // or value/expire writes.  Lets the GLOBAL sync skip owner-slot
  // re-verification for shards whose mapping is provably unchanged
  // since the last sync (O(active-gslots) -> O(changed)).
  uint64_t map_generation = 0;
  // Evictions that found no slot free of pending writes and promotions
  // (the second and third rungs of lookup_or_assign's ladder).  A
  // diagnostic of the port: the JAX table does not count them.
  int64_t starved_evictions = 0;

  // ---- two-tier mode (back_capacity > 0) ----------------------------
  // The device keeps a small FRONT table (every kernel lane addresses
  // it) plus a big BACK table written only by batched demotion moves.
  // Front LRU eviction DEMOTES the row (device move, state preserved)
  // instead of dropping it; a later lookup PROMOTES it back.  The host
  // tracks key locations and queues the device moves; dispatchers drain
  // them (gt_table_take_moves -> ops/buckets.py apply_moves) before any
  // launch that reads front rows.  The back tier evicts FIFO (ring
  // cursor): only then is bucket state truly lost, matching the
  // reference's plain LRU loss at total capacity.
  int64_t back_capacity = 0;
  std::unordered_map<std::string, int32_t> key_to_back;
  std::vector<std::string> back_key;  // back slot -> key
  std::vector<uint8_t> back_mapped;
  std::vector<int64_t> back_expire;
  int64_t back_clock = 0;  // FIFO allocation cursor
  int64_t back_size = 0, back_evictions = 0, demotions = 0, promotions = 0;
  // Pending device moves.  promo kind: 0 = gather from back slot, 1 =
  // gather from FRONT slot (a key demoted and re-promoted inside one
  // drain window: its row never reached the back table, so the device
  // copies front->front; the demo record is cancelled).
  std::vector<int32_t> mv_promo_kind, mv_promo_src, mv_promo_dst;
  std::vector<int32_t> mv_demo_src, mv_demo_dst;
  // back slot -> index into mv_demo (this window) for cycle rewrite
  std::unordered_map<int32_t, int32_t> pending_demo_by_back;
  // per front slot: index into mv_promo_* of a queued-but-undrained
  // promotion (-1 none).  The row is not on device yet, so eviction
  // must prefer other slots and, if forced, CANCEL the record.
  std::vector<int32_t> pending_promo;

  explicit Table(int64_t cap)
      : capacity(cap),
        slot_key(cap),
        slot_mapped(cap, 0),
        expire_ms(cap, 0),
        pending_write(cap, 0),
        lru_prev(cap, -1),
        lru_next(cap, -1),
        pending_promo(cap, -1) {
    free_slots.reserve(cap);
    for (int64_t i = cap - 1; i >= 0; --i) free_slots.push_back((int32_t)i);
    key_to_slot.reserve((size_t)cap * 2);
  }

  void lru_unlink(int32_t s) {
    int32_t p = lru_prev[s], n = lru_next[s];
    if (p >= 0) lru_next[p] = n; else if (lru_head == s) lru_head = n;
    if (n >= 0) lru_prev[n] = p; else if (lru_tail == s) lru_tail = p;
    lru_prev[s] = lru_next[s] = -1;
  }

  void lru_push_back(int32_t s) {  // most recently used
    lru_prev[s] = lru_tail;
    lru_next[s] = -1;
    if (lru_tail >= 0) lru_next[lru_tail] = s;
    lru_tail = s;
    if (lru_head < 0) lru_head = s;
  }

  void touch(int32_t s) {
    if (lru_tail == s) return;
    lru_unlink(s);
    lru_push_back(s);
  }

  void unmap_slot(int32_t s) {
    if (!slot_mapped[s]) return;
    key_to_slot.erase(slot_key[s]);
    slot_key[s].clear();
    slot_mapped[s] = 0;
    expire_ms[s] = 0;
    lru_unlink(s);
    free_slots.push_back(s);
    ++map_generation;
  }


  void enable_back(int64_t cap) {
    back_capacity = cap;
    back_key.resize(cap);
    back_mapped.assign(cap, 0);
    back_expire.assign(cap, 0);
    key_to_back.reserve((size_t)cap * 2);
  }

  void unmap_back(int32_t b) {
    if (!back_mapped[b]) return;
    key_to_back.erase(back_key[b]);
    back_key[b].clear();
    back_mapped[b] = 0;
    back_expire[b] = 0;
    --back_size;
  }

  // Neutralize a queued demo targeting back slot b (src=-1 device
  // no-op): required whenever b is freed or reused mid-window, or the
  // move launch could write two rows onto one destination.
  void cancel_pending_demo(int32_t b) {
    auto pd = pending_demo_by_back.find(b);
    if (pd != pending_demo_by_back.end()) {
      mv_demo_src[(size_t)pd->second] = -1;
      pending_demo_by_back.erase(pd);
    }
  }

  // A back slot mid-promotion: lookup_or_assign resolves the promo
  // source BEFORE allocating the front slot, and that allocation's
  // eviction can demote another key; alloc_back must not wrap the FIFO
  // cursor onto the in-flight source, or the promoted key would adopt
  // the victim's row.
  int32_t promo_in_flight = -1;

  // FIFO ring allocation; wrapping onto a live entry drops it (the
  // two-tier design's only true state loss).  Returns -1 when no slot
  // is usable (back_capacity==1 and that slot is mid-promotion): the
  // caller drops the row instead of demoting.
  int32_t alloc_back(const std::string& key) {
    int32_t b = (int32_t)(back_clock % back_capacity);
    ++back_clock;
    if (b == promo_in_flight) {
      if (back_capacity == 1) return -1;
      b = (int32_t)(back_clock % back_capacity);
      ++back_clock;
    }
    if (back_mapped[b]) {
      unmap_back(b);
      ++back_evictions;
      ++evictions;
    }
    cancel_pending_demo(b);
    back_key[b] = key;
    back_mapped[b] = 1;
    key_to_back.emplace(key, b);
    ++back_size;
    return b;
  }

  // Evict the key occupying front slot s (LRU eviction,
  // cache.go:115-130).  In two-tier mode a live occupant is DEMOTED:
  // queue the device row move front[s] -> back[b] and move the host
  // mapping.  Expired occupants are simply dropped.
  void evict_front(int32_t s, int64_t now_ms) {
    lru_unlink(s);
    const std::string k = std::move(slot_key[s]);
    key_to_slot.erase(k);
    slot_mapped[s] = 0;
    // Demotion preserves state ONLY when the device row at s really is
    // this key's current state.  Under the all-pending starvation
    // fallback the chosen slot may have (a) a queued promotion whose
    // row hasn't arrived (demoting would park the PREVIOUS occupant's
    // row under this key's name): cancel the promo and drop instead;
    // (b) an in-flight batch write (pending_write): the row is mid-air,
    // drop.  Both degrade to the reference's loss, never to serving
    // another key's counters.
    if (pending_promo[s] >= 0) {
      mv_promo_src[(size_t)pending_promo[s]] = -1;  // device no-op
      pending_promo[s] = -1;
      ++back_evictions;  // the promoted state is lost
    } else if (back_capacity > 0 && pending_write[s] == 0 &&
               expire_ms[s] >= now_ms) {
      int32_t b = alloc_back(k);
      if (b >= 0) {
        back_expire[b] = expire_ms[s];
        pending_demo_by_back[b] = (int32_t)mv_demo_src.size();
        mv_demo_src.push_back(s);
        mv_demo_dst.push_back(b);
        ++demotions;
      } else {
        ++back_evictions;  // degenerate: nowhere to park the row
      }
    }
    expire_ms[s] = 0;
    ++evictions;
    ++map_generation;
  }

  // Re-map an unmapped slot to `key` (the remove-then-recreate chain:
  // an earlier lane freed the slot, a later round recreated the key on
  // device).  Returns false when the key is meanwhile mapped elsewhere.
  // Negative expire is the narrow-wire keep-sentinel; an unmapped slot
  // has no prior value to keep, so it clamps to 0 (already expired).
  bool remap(int32_t s, const char* key, size_t len, int64_t expire) {
    std::string k(key, len);
    if (!key_to_slot.emplace(k, s).second) return false;
    slot_key[s] = std::move(k);
    slot_mapped[s] = 1;
    expire_ms[s] = expire >= 0 ? expire : 0;
    for (size_t j = free_slots.size(); j > 0; --j) {
      if (free_slots[j - 1] == s) {
        free_slots[j - 1] = free_slots.back();
        free_slots.pop_back();
        break;
      }
    }
    lru_push_back(s);
    ++map_generation;
    return true;
  }

  // (slot, exists): exists=false means kernel treats as fresh create.
  // pending_write liveness and pending-aware eviction only matter
  // between a columnar batch's plan and its commit.
  std::pair<int32_t, bool> lookup_or_assign(const char* key, size_t len,
                                            int64_t now_ms) {
    std::string k(key, len);
    auto it = key_to_slot.find(k);
    if (it != key_to_slot.end()) {
      int32_t s = it->second;
      touch(s);
      // Strict expiry (cache.go:151); an uncommitted in-flight write
      // makes the device row authoritative regardless of the stale
      // host expire (pipelined batches — the kernel revalidates).
      if (expire_ms[s] >= now_ms || pending_write[s] > 0) return {s, true};
      return {s, false};  // expired: recycle same slot in place
    }
    // Two-tier: a live row demoted to the back tier promotes (a
    // logical cache hit: the state survives the round trip).
    int32_t promo_b = -1;
    if (back_capacity > 0) {
      auto itb = key_to_back.find(k);
      if (itb != key_to_back.end()) {
        int32_t b = itb->second;
        if (back_expire[b] >= now_ms) {
          promo_b = b;
        } else {
          cancel_pending_demo(b);
          unmap_back(b);  // expired in back: plain miss-create
        }
      }
    }
    promo_in_flight = promo_b;  // shield the source from FIFO reuse
    int32_t s;
    if (!free_slots.empty()) {
      s = free_slots.back();
      free_slots.pop_back();
    } else {
      // Evict LRU (cache.go:115-130), skipping slots whose device write
      // from an earlier pipelined batch is still in flight (stealing
      // one drops that batch's device state mid-air and invalidates its
      // plan-time chaining assumptions) and slots awaiting a queued
      // promotion this drain window (their device row lands with the
      // NEXT move launch; demoting one would copy a pre-promotion
      // row).  Walk from the cold end; under pipelining the pending
      // slots are the recently-touched ones, so the head is normally
      // clean.  Preference ladder: fully clean slot > promo-free slot
      // (in-flight write: evict_front drops instead of demoting) > raw
      // head (pending promo: evict_front cancels the record — loss,
      // never corruption).
      s = -1;
      for (int32_t cand = lru_head; cand >= 0; cand = lru_next[cand]) {
        if (pending_write[cand] == 0 && pending_promo[cand] < 0) {
          s = cand;
          break;
        }
      }
      if (s < 0) {
        ++starved_evictions;
        for (int32_t cand = lru_head; cand >= 0; cand = lru_next[cand]) {
          if (pending_promo[cand] < 0) {
            s = cand;
            break;
          }
        }
      }
      if (s < 0) s = lru_head;
      evict_front(s, now_ms);
    }
    key_to_slot.emplace(std::move(k), s);
    slot_key[s].assign(key, len);
    slot_mapped[s] = 1;
    lru_push_back(s);
    ++map_generation;
    if (promo_b >= 0) {
      expire_ms[s] = back_expire[promo_b];
      // Queue the device move.  A demo still pending for this back
      // slot (same drain window) means the row never left the front
      // table: copy front->front (kind 1) instead of reading the
      // not-yet-written back slot, and cancel the parked demo copy
      // (its destination is now free for same-window reuse).
      auto pd = pending_demo_by_back.find(promo_b);
      if (pd != pending_demo_by_back.end()) {
        mv_promo_kind.push_back(1);
        mv_promo_src.push_back(mv_demo_src[(size_t)pd->second]);
        mv_demo_src[(size_t)pd->second] = -1;
        pending_demo_by_back.erase(pd);
      } else {
        mv_promo_kind.push_back(0);
        mv_promo_src.push_back(promo_b);
      }
      mv_promo_dst.push_back(s);
      pending_promo[s] = (int32_t)mv_promo_dst.size() - 1;
      unmap_back(promo_b);
      promo_in_flight = -1;
      ++promotions;
      return {s, true};
    }
    promo_in_flight = -1;
    expire_ms[s] = 0;
    return {s, false};
  }
};

struct Batch {
  Table* table;
  const char* keys;        // concatenated key bytes (borrowed)
  const int64_t* offsets;  // n+1 offsets into keys (borrowed)
  int64_t n;
  int64_t now_ms;
  // Lanes not yet scheduled, in request order (per-key order is what
  // matters; cross-key order is free, as in the reference's goroutine
  // fan-out).
  std::vector<int32_t> pending;
  // per-lane resolution cache (a deferred lane keeps its captured slot)
  std::vector<int32_t> slot;
  std::vector<uint8_t> exists, resolved;
  bool committed = false;
  // lanes in emission order across all rounds, consumed by
  // gt_batch_commit_plan
  std::vector<int32_t> plan_order;

  Batch(Table* t, const char* k, const int64_t* off, int64_t n_, int64_t now)
      : table(t), keys(k), offsets(off), n(n_), now_ms(now),
        slot(n_, -1), exists(n_, 0), resolved(n_, 0) {
    pending.reserve(n_);
    for (int64_t i = 0; i < n_; ++i) pending.push_back((int32_t)i);
  }

  const char* key_ptr(int64_t i) const { return keys + offsets[i]; }
  size_t key_len(int64_t i) const { return (size_t)(offsets[i + 1] - offsets[i]); }
};

// Per-table lock for the extern-C surface (see the thread-safety
// contract at the top of the file).
#define GT_LOCK(tp) std::lock_guard<std::recursive_mutex> _gt_guard((tp)->mu)

}  // namespace

extern "C" {

void* gt_table_new(int64_t capacity) { return new Table(capacity); }
void gt_table_free(void* t) { delete (Table*)t; }
int64_t gt_table_len(void* t) {
  GT_LOCK((Table*)t);
  return (int64_t)((Table*)t)->key_to_slot.size();
}

int32_t gt_table_get_slot(void* tv, const char* key, int64_t len) {
  Table* t = (Table*)tv;
  GT_LOCK(t);
  auto it = t->key_to_slot.find(std::string(key, (size_t)len));
  return it == t->key_to_slot.end() ? -1 : it->second;
}

// Evictions so far: plan_grouped_python reads it around every lookup to
// detect an eviction.
int64_t gt_table_evictions(void* tv) {
  GT_LOCK((Table*)tv);
  return ((Table*)tv)->evictions;
}

// Mapping-change generation (see Table::map_generation): equal reads
// across two points in time guarantee no key->slot mapping changed
// between them.
uint64_t gt_table_generation(void* tv) {
  GT_LOCK((Table*)tv);
  return ((Table*)tv)->map_generation;
}

// Single-key resolve (the dataclass path's planner drives lookups one
// at a time).
void gt_table_lookup_or_assign(void* tv, const char* key, int64_t len,
                               int64_t now_ms, int32_t* out_slot,
                               uint8_t* out_exists) {
  GT_LOCK((Table*)tv);
  auto [s, e] = ((Table*)tv)->lookup_or_assign(key, (size_t)len, now_ms);
  *out_slot = s;
  *out_exists = e ? 1 : 0;
}

// ---- two-tier back tier -----------------------------------------------

void gt_table_enable_back(void* tv, int64_t back_capacity) {
  GT_LOCK((Table*)tv);
  ((Table*)tv)->enable_back(back_capacity);
}

// out: total keys (front+back), back keys, demotions, promotions,
// back evictions (true state loss)
void gt_table_tier_stats(void* tv, int64_t* out) {
  Table* t = (Table*)tv;
  GT_LOCK(t);
  out[0] = (int64_t)t->key_to_slot.size() + t->back_size;
  out[1] = t->back_size;
  out[2] = t->demotions;
  out[3] = t->promotions;
  out[4] = t->back_evictions;
}

int64_t gt_table_starved_evictions(void* tv) {
  GT_LOCK((Table*)tv);
  return ((Table*)tv)->starved_evictions;
}

void gt_table_move_counts(void* tv, int64_t* n_promo, int64_t* n_demo) {
  Table* t = (Table*)tv;
  GT_LOCK(t);
  *n_promo = (int64_t)t->mv_promo_src.size();
  *n_demo = (int64_t)t->mv_demo_src.size();
}

// Drain the queued device moves into caller arrays and close the drain
// window: after this call the rows are considered ON DEVICE in their new
// homes, so the dispatcher MUST run the move launch (ops/buckets.py
// apply_moves) with exactly these records before any other launch.
// The caller passes its arrays' capacities: when more moves are queued
// than fit (a planner in another thread queued some since the caller
// read gt_table_move_counts), nothing is taken and 1 is returned, so the
// count and the copy are one atomic step.  0 on success.
int32_t gt_table_take_moves(void* tv, int64_t cap_promo, int64_t cap_demo,
                            int32_t* promo_kind, int32_t* promo_src,
                            int32_t* promo_dst, int32_t* demo_src,
                            int32_t* demo_dst) {
  Table* t = (Table*)tv;
  GT_LOCK(t);
  if ((int64_t)t->mv_promo_src.size() > cap_promo ||
      (int64_t)t->mv_demo_src.size() > cap_demo)
    return 1;
  std::memcpy(promo_kind, t->mv_promo_kind.data(),
              t->mv_promo_kind.size() * sizeof(int32_t));
  std::memcpy(promo_src, t->mv_promo_src.data(),
              t->mv_promo_src.size() * sizeof(int32_t));
  std::memcpy(promo_dst, t->mv_promo_dst.data(),
              t->mv_promo_dst.size() * sizeof(int32_t));
  std::memcpy(demo_src, t->mv_demo_src.data(),
              t->mv_demo_src.size() * sizeof(int32_t));
  std::memcpy(demo_dst, t->mv_demo_dst.data(),
              t->mv_demo_dst.size() * sizeof(int32_t));
  for (int32_t s : t->mv_promo_dst) t->pending_promo[s] = -1;
  t->mv_promo_kind.clear();
  t->mv_promo_src.clear();
  t->mv_promo_dst.clear();
  t->mv_demo_src.clear();
  t->mv_demo_dst.clear();
  t->pending_demo_by_back.clear();
  return 0;
}

// Snapshot protocol for the back tier (Loader.Save needs every live
// item): gt_table_back_size for buffer sizing, then gt_table_back_keys
// fills (back_slots, expire, offsets[count+1], key bytes), in the hash
// map's iteration order (the JAX table's order, same container).
void gt_table_back_size(void* tv, int64_t* count, int64_t* total_bytes) {
  Table* t = (Table*)tv;
  GT_LOCK(t);
  *count = t->back_size;
  int64_t bytes = 0;
  for (auto& kv : t->key_to_back) bytes += (int64_t)kv.first.size();
  *total_bytes = bytes;
}

void gt_table_back_keys(void* tv, int32_t* slots, int64_t* expire,
                        int64_t* offsets, char* bytes) {
  Table* t = (Table*)tv;
  GT_LOCK(t);
  int64_t i = 0, off = 0;
  for (auto& kv : t->key_to_back) {
    slots[i] = kv.second;
    expire[i] = t->back_expire[kv.second];
    offsets[i] = off;
    std::memcpy(bytes + off, kv.first.data(), kv.first.size());
    off += (int64_t)kv.first.size();
    ++i;
  }
  offsets[i] = off;
}

// Load another table's back tier into this (fresh, enabled) one: n
// entries (back slot, expire, key) in the given order and the FIFO
// cursor (MeshBucketStore.load_state_numpy).  No moves are queued.
void gt_table_load_back(void* tv, const int32_t* slots, const int64_t* expire,
                        const char* keys, const int64_t* offsets, int64_t n,
                        int64_t back_clock) {
  Table* t = (Table*)tv;
  GT_LOCK(t);
  for (int64_t i = 0; i < n; ++i) {
    int32_t b = slots[i];
    if (b < 0 || b >= t->back_capacity) continue;
    t->unmap_back(b);
    std::string k(keys + offsets[i], (size_t)(offsets[i + 1] - offsets[i]));
    t->back_key[b] = k;
    t->back_mapped[b] = 1;
    t->back_expire[b] = expire[i];
    t->key_to_back.emplace(std::move(k), b);
    ++t->back_size;
  }
  t->back_clock = back_clock;
}

// Bulk expiry read for the narrow-wire keep-sentinel decode: lanes
// whose expire/reset passed through unchanged reconstruct the absolute
// value from the host table instead of a (clippable) delta.
void gt_table_get_expire(void* tv, const int32_t* slots, int64_t n,
                         int64_t* out) {
  Table* t = (Table*)tv;
  GT_LOCK(t);
  for (int64_t i = 0; i < n; ++i)
    out[i] = (slots[i] >= 0 && slots[i] < t->capacity) ? t->expire_ms[slots[i]] : 0;
}

// Commit with the staleness guard (the key check of the JAX package's slot_table.py::commit): a
// lane whose slot was remapped to a different key after scheduling (LRU
// eviction mid-batch) must not touch the slot's new owner.  Used to load
// a JAX store's key map into a fresh table (MeshBucketStore.load_state_numpy).
void gt_table_commit_keys(void* tv, const int32_t* slots,
                          const int64_t* expire, const uint8_t* removed,
                          const char* keys, const int64_t* offsets,
                          int64_t n) {
  Table* t = (Table*)tv;
  GT_LOCK(t);
  for (int64_t i = 0; i < n; ++i) {
    int32_t s = slots[i];
    if (s < 0) continue;
    size_t len = (size_t)(offsets[i + 1] - offsets[i]);
    if (!t->slot_mapped[s]) {
      if (!removed[i]) t->remap(s, keys + offsets[i], len, expire[i]);
      continue;
    }
    if (t->slot_key[s].compare(0, std::string::npos, keys + offsets[i], len) != 0)
      continue;  // slot remapped mid-batch; this lane is stale
    if (removed[i]) t->unmap_slot(s);
    else t->expire_ms[s] = expire[i];
  }
}

void gt_table_set_expire(void* tv, int32_t slot, int64_t expire) {
  GT_LOCK((Table*)tv);
  ((Table*)tv)->expire_ms[slot] = expire;
}

// Snapshot protocol: first call gt_table_keys_size for total bytes, then
// gt_table_keys to fill (slots, offsets[count+1], bytes).  The order is
// the hash map's iteration order, which a snapshot's bytes follow.
void gt_table_keys_size(void* tv, int64_t* count, int64_t* total_bytes) {
  Table* t = (Table*)tv;
  GT_LOCK(t);
  *count = (int64_t)t->key_to_slot.size();
  int64_t bytes = 0;
  for (auto& kv : t->key_to_slot) bytes += (int64_t)kv.first.size();
  *total_bytes = bytes;
}

void gt_table_keys(void* tv, int32_t* slots, int64_t* offsets, char* bytes) {
  Table* t = (Table*)tv;
  GT_LOCK(t);
  int64_t i = 0, off = 0;
  for (auto& kv : t->key_to_slot) {
    slots[i] = kv.second;
    offsets[i] = off;
    std::memcpy(bytes + off, kv.first.data(), kv.first.size());
    off += (int64_t)kv.first.size();
    ++i;
  }
  offsets[i] = off;
}

// Bulk forms of the per-key loops of the JAX store's transfer plane
// (parallel/mesh.py _gather_transfer_locked, commit_transfer), one call
// per batch instead of one per key.  Each walks the keys in the given
// order, routes key i to shard fnv1a64(key) % S (shard_of_key), and
// does what the per-key loop does there, in the same order: LRU
// eviction depends on it.
//
// gt_mesh_get_slots: shard[i] and the key's slot there, -1 if absent.
void gt_mesh_get_slots(void** tables, int64_t S, const char* keys,
                       const int64_t* offsets, int64_t n, int32_t* shard,
                       int32_t* slot) {
  for (int64_t i = 0; i < n; ++i) {
    const char* p = keys + offsets[i];
    const size_t len = (size_t)(offsets[i + 1] - offsets[i]);
    const int32_t s = (int32_t)(fnv1a64(p, p + len) % (uint64_t)S);
    Table* t = (Table*)tables[s];
    GT_LOCK(t);
    auto it = t->key_to_slot.find(std::string(p, len));
    shard[i] = s;
    slot[i] = it == t->key_to_slot.end() ? -1 : it->second;
  }
}

// gt_mesh_lookup_or_assign: shard[i] and lookup_or_assign's (slot,
// exists) there.
void gt_mesh_lookup_or_assign(void** tables, int64_t S, const char* keys,
                              const int64_t* offsets, int64_t n,
                              int64_t now_ms, int32_t* shard, int32_t* slot,
                              uint8_t* exists) {
  for (int64_t i = 0; i < n; ++i) {
    const char* p = keys + offsets[i];
    const size_t len = (size_t)(offsets[i + 1] - offsets[i]);
    const int32_t s = (int32_t)(fnv1a64(p, p + len) % (uint64_t)S);
    Table* t = (Table*)tables[s];
    GT_LOCK(t);
    auto [sl, e] = t->lookup_or_assign(p, len, now_ms);
    shard[i] = s;
    slot[i] = sl;
    exists[i] = e ? 1 : 0;
  }
}

// gt_mesh_set_expire: expire_ms of (shard[i], slot[i]) = expire[i], in
// lane order (a later lane for the same slot wins).
void gt_mesh_set_expire(void** tables, const int32_t* shard,
                        const int32_t* slot, const int64_t* expire, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    Table* t = (Table*)tables[shard[i]];
    GT_LOCK(t);
    t->expire_ms[slot[i]] = expire[i];
  }
}

void* gt_batch_begin(void* tv, const char* keys, const int64_t* offsets,
                     int64_t n, int64_t now_ms) {
  return new Batch((Table*)tv, keys, offsets, n, now_ms);
}

// Round scheduler behind gt_batch_plan_grouped: plans EVERY remaining
// round upfront — no interleaved device commits — so the whole batch
// runs as ONE kernel launch (the kernel loops over rounds).  Walks
// b->pending (in request order) emitting rounds from `round` upward,
// deferring later same-key occurrences and eviction collisions; each
// emitted lane gets occ=0, write=1 — every round-scheme lane scatters.
//
// Chained lanes (key already emitted in an earlier round of this batch)
// get exists=1: the device row was just written by this very batch, so
// device-side liveness (expire_at >= now) is authoritative — including
// the remove-then-recreate chain, where the earlier round stamped
// expire_at=0.
//
// key -> slot at first emission: a later lane is chained (device-
// authoritative) only while it still resolves to that same slot; a
// mid-batch eviction reassigning the key to a fresh slot falls back
// to the host's exists (the state was lost, as in the reference's
// LRU eviction of a live item).
static int64_t plan_rounds(Batch* b, int64_t round, int32_t* round_id,
                           int32_t* slots, uint8_t* exists, int32_t* occ,
                           uint8_t* write,
                           std::unordered_map<int32_t, std::string_view>& slot_owner) {
  Table* t = b->table;
  while (!b->pending.empty()) {
    std::unordered_map<std::string_view, int> seen_keys;
    std::unordered_map<int32_t, int> used_slots;
    seen_keys.reserve(b->pending.size() * 2);
    used_slots.reserve(b->pending.size() * 2);
    std::vector<int32_t> deferred;
    for (int32_t i : b->pending) {
      std::string_view k(b->key_ptr(i), b->key_len(i));
      if (seen_keys.count(k)) {
        deferred.push_back(i);
        continue;
      }
      if (!b->resolved[i]) {
        auto [s, e] = t->lookup_or_assign(b->key_ptr(i), b->key_len(i), b->now_ms);
        b->slot[i] = s;
        b->exists[i] = e ? 1 : 0;
        b->resolved[i] = 1;
      }
      // Slot takeover: a DIFFERENT key's create (mid-batch eviction)
      // is already scheduled on this lane's captured slot — running
      // here would corrupt the new owner's device state.  Re-resolve:
      // this key is no longer mapped, so it gets a fresh slot.
      auto so = slot_owner.find(b->slot[i]);
      if (so != slot_owner.end() && so->second != k) {
        auto [s, e] = t->lookup_or_assign(b->key_ptr(i), b->key_len(i), b->now_ms);
        b->slot[i] = s;
        b->exists[i] = e ? 1 : 0;
      }
      if (used_slots.count(b->slot[i])) {  // eviction collision: defer as-is
        deferred.push_back(i);
        seen_keys.emplace(k, 1);
        continue;
      }
      round_id[i] = (int32_t)round;
      slots[i] = b->slot[i];
      occ[i] = 0;
      write[i] = 1;
      so = slot_owner.find(b->slot[i]);
      exists[i] = (so != slot_owner.end() && so->second == k)
                      ? 1  // chained: device state authoritative
                      : b->exists[i];
      b->plan_order.push_back(i);
      ++t->pending_write[b->slot[i]];
      seen_keys.emplace(k, 1);
      slot_owner[b->slot[i]] = k;
      used_slots.emplace(b->slot[i], 1);
    }
    b->pending.swap(deferred);
    ++round;
  }
  return round;
}

// Fold the planned batch's kernel outputs (indexed by ORIGINAL lane)
// back into the table, in emission order so the last write per key
// wins.  Unlike the per-round staleness guard, an unmapped slot is
// re-mapped to the lane's key: that is the remove-then-recreate chain
// (token RESET_REMAINING freed it, a later round recreated it on
// device).  A slot owned by a DIFFERENT key means a later in-batch
// eviction took it over — this lane's write is stale, skip.
void gt_batch_commit_plan(void* bv, const int64_t* new_expire,
                          const uint8_t* removed) {
  Batch* b = (Batch*)bv;
  Table* t = b->table;
  GT_LOCK(t);
  b->committed = true;
  for (int32_t i : b->plan_order) {
    int32_t s = b->slot[i];
    if (s < 0) continue;
    if (t->pending_write[s] > 0) --t->pending_write[s];
    bool mine = t->slot_mapped[s] &&
                t->slot_key[s].compare(0, std::string::npos, b->key_ptr(i),
                                       b->key_len(i)) == 0;
    if (removed[i]) {
      if (mine) t->unmap_slot(s);
      continue;
    }
    if (mine) {
      // Negative expire is the narrow-wire "unchanged" sentinel
      // (ops/buckets.py unpack_output32): the kernel passed the slot's
      // pre-batch expiry through, so the host value is already right.
      if (new_expire[i] >= 0) t->expire_ms[s] = new_expire[i];
    } else if (!t->slot_mapped[s]) {
      t->remap(s, b->key_ptr(i), b->key_len(i), new_expire[i]);
    }
  }
}

// Grouped full plan: uniform duplicate groups collapse into round 0.
//
// A "uniform group" is every lane of one key whose request config
// (algorithm, behavior, hits, limit, duration, greg columns) is
// identical and carries no RESET_REMAINING (whose remove-recreate chain
// is inherently sequential).  Such a group needs no rounds at all: the
// kernel computes each occurrence's response in closed form from the
// occurrence index (ops/buckets.py analytic-duplicate math) and only
// the LAST occurrence scatters.  Lanes that do not qualify fall back to
// the round scheme starting at round 1.  This turns hot-key skew — the
// reference's thundering-herd case (its BATCHING exists for exactly
// this, architecture.md:19-25) — from O(max multiplicity) sequential
// kernel rounds into O(1).
//
// Outputs per lane: round_id, slot, exists, occ (occurrence index
// within a uniform group; 0 otherwise), write (1 when this lane's lane
// scatters state: the last occurrence of a uniform group, or every
// round-scheme lane).  Returns the round count.
int64_t gt_batch_plan_grouped(void* bv, const int32_t* algo,
                              const int32_t* behavior, const int64_t* hits,
                              const int64_t* limit, const int64_t* duration,
                              const int64_t* greg_e, const int64_t* greg_d,
                              int32_t reset_mask, int32_t* round_id,
                              int32_t* slots, uint8_t* exists, int32_t* occ,
                              uint8_t* write) {
  Batch* b = (Batch*)bv;
  Table* t = b->table;
  GT_LOCK(t);
  b->plan_order.clear();
  b->plan_order.reserve((size_t)b->n);

  // Group lanes by key, preserving first-appearance order.  Keys view
  // the borrowed packed buffer — no per-lane allocation — and members
  // live in a flat CSR layout (gid pass -> counting sort) instead of
  // one heap-allocated vector per group: at service batch sizes the
  // planner runs once per dispatch over tens of thousands of MOSTLY
  // UNIQUE keys, where per-group vectors cost one malloc per lane and
  // dominated the whole plan.
  std::unordered_map<std::string_view, int32_t> group_of;
  group_of.reserve((size_t)b->n * 2);
  std::vector<int32_t> gid((size_t)b->n);
  std::vector<int32_t> gcount;
  gcount.reserve((size_t)b->n);
  int32_t n_groups = 0;
  for (int64_t i = 0; i < b->n; ++i) {
    std::string_view k(b->key_ptr(i), b->key_len(i));
    auto [it, fresh] = group_of.emplace(k, n_groups);
    if (fresh) {
      ++n_groups;
      gcount.push_back(0);
    }
    gid[(size_t)i] = it->second;
    ++gcount[(size_t)it->second];
  }
  // CSR offsets + member fill (members of one group stay in request
  // order — the occurrence index below depends on it).
  std::vector<int32_t> goff((size_t)n_groups + 1);
  goff[0] = 0;
  for (int32_t g = 0; g < n_groups; ++g) goff[(size_t)g + 1] = goff[(size_t)g] + gcount[(size_t)g];
  std::vector<int32_t> gmembers((size_t)b->n);
  {
    std::vector<int32_t> cursor(goff.begin(), goff.end() - 1);
    for (int64_t i = 0; i < b->n; ++i)
      gmembers[(size_t)cursor[(size_t)gid[(size_t)i]]++] = (int32_t)i;
  }

  std::unordered_map<int32_t, int> used0;  // slots written in round 0
  used0.reserve((size_t)n_groups * 2);
  // Seed the slot-owner map with round-0 groups so slow lanes detect
  // takeovers of (and chain onto) grouped slots.
  std::unordered_map<int32_t, std::string_view> slot_owner;
  slot_owner.reserve((size_t)b->n * 2);
  std::vector<int32_t> slow;  // lanes for the round scheme
  for (int32_t g = 0; g < n_groups; ++g) {
    const int32_t* mem = gmembers.data() + goff[(size_t)g];
    size_t g_size = (size_t)(goff[(size_t)g + 1] - goff[(size_t)g]);
    int32_t first = mem[0];
    bool uniform = (behavior[first] & reset_mask) == 0;
    for (size_t j = 1; uniform && j < g_size; ++j) {
      int32_t i = mem[j];
      uniform = algo[i] == algo[first] && behavior[i] == behavior[first] &&
                hits[i] == hits[first] && limit[i] == limit[first] &&
                duration[i] == duration[first] &&
                greg_e[i] == greg_e[first] && greg_d[i] == greg_d[first];
    }
    int64_t ev_before = t->evictions;
    auto [s, e] =
        t->lookup_or_assign(b->key_ptr(first), b->key_len(first), b->now_ms);
    b->slot[first] = s;
    b->exists[first] = e ? 1 : 0;
    b->resolved[first] = 1;
    // An eviction may have stolen the slot from a key with EARLIER
    // lanes in this batch; scheduling this group in round 0 would run
    // the create before the victim's lanes.  Demote to the slow path,
    // whose per-round slot-collision deferral orders it correctly.
    bool evicted = t->evictions != ev_before;
    if (uniform && !evicted && !used0.count(s)) {
      used0.emplace(s, 1);
      slot_owner[s] = std::string_view(b->key_ptr(first), b->key_len(first));
      ++t->pending_write[s];
      for (size_t j = 0; j < g_size; ++j) {
        int32_t i = mem[j];
        round_id[i] = 0;
        slots[i] = s;
        exists[i] = e ? 1 : 0;
        occ[i] = (int32_t)j;
        write[i] = (j + 1 == g_size) ? 1 : 0;
        b->slot[i] = s;
        if (write[i]) b->plan_order.push_back(i);
      }
    } else {
      for (size_t j = 0; j < g_size; ++j) slow.push_back(mem[j]);
    }
  }
  if (slow.empty()) return 1;

  // Round scheme for the leftovers, starting at round 1 (round 0 is the
  // grouped dispatch).  Same chaining/deferral rules as gt_batch_plan.
  std::sort(slow.begin(), slow.end());
  b->pending.assign(slow.begin(), slow.end());
  return plan_rounds(b, 1, round_id, slots, exists, occ, write, slot_owner);
}

void gt_batch_free(void* bv) {
  Batch* b = (Batch*)bv;
  // A planned-but-never-committed batch (error path) must release its
  // pending-write claims or the slots stay device-authoritative forever.
  // Locked: Python GC can run this from any thread while a younger
  // batch's plan is mid-flight on the same table.
  if (!b->committed) {
    Table* t = b->table;
    GT_LOCK(t);
    for (int32_t i : b->plan_order) {
      int32_t s = b->slot[i];
      if (s >= 0 && t->pending_write[s] > 0) --t->pending_write[s];
    }
  }
  delete b;
}

// ---------------------------------------------------------------------
// FNV-1 / FNV-1a 64 over a packed key batch (replicated_hash.go:31 uses
// fasthash/fnv1; host-side ring lookups hash every key of every batch).
void gt_fnv1_batch(const char* keys, const int64_t* offsets, int64_t n,
                   int32_t variant_1a, uint64_t* out) {
  for (int64_t i = 0; i < n; ++i) {
    const char* p = keys + offsets[i];
    const char* end = keys + offsets[i + 1];
    out[i] = variant_1a ? fnv1a64(p, end) : fnv1_64(p, end);
  }
}

}  // extern "C"

namespace {
// ---------------------------------------------------------------------
// Mesh planner: shard-bucket + per-shard grouped round planning + padded
// fill + decode/commit for a WHOLE device mesh in single C++ calls.
//
// Call sequence per batch (ColumnarPipeline discipline):
//
//   gt_mesh_begin(tables[S], keys, n)    -> handle + per-shard counts
//   gt_mesh_plan_grouped(h, cols, P, ..) -> padded [S,P] plan arrays,
//                                           pos[n] (lane -> padded idx)
//   ... device dispatch (Python/numpy packs the wire from the padded
//       arrays with vectorized ops) ...
//   gt_mesh_finish_{narrow,wide}(h, ..)  -> response columns in ORIGINAL
//                                           order + slot-table commit
//   gt_mesh_free(h)

struct MeshPlan {
  int64_t S = 0, n = 0, now_ms = 0, P = 0;
  std::vector<Table*> tables;
  std::vector<std::vector<char>> skeys;      // per-shard packed key bytes
  std::vector<std::vector<int64_t>> soffs;   // per-shard offsets [m+1]
  std::vector<std::vector<int32_t>> lanes;   // per-shard original lane ids
  std::vector<void*> batches;                // per-shard Batch* (plan phase)
  std::vector<std::vector<int32_t>> pslot;   // per-shard planned slots [m]
  std::vector<std::vector<int64_t>> pre_exp; // plan-time expiry snapshot [m]
};

}  // namespace

extern "C" {

// Phase 1: hash every key (fnv1a-64 % S, the static shardmap of
// parallel/mesh.py shard_of_key) and bucket keys/lanes per shard.
// Fills counts[S]; returns the handle.
void* gt_mesh_begin(void** tables, int64_t S, const char* keys,
                    const int64_t* offsets, int64_t n, int64_t now_ms,
                    int64_t* counts) {
  MeshPlan* mp = new MeshPlan();
  mp->S = S;
  mp->n = n;
  mp->now_ms = now_ms;
  mp->tables.assign((Table**)tables, (Table**)tables + S);
  mp->skeys.resize(S);
  mp->soffs.resize(S);
  mp->lanes.resize(S);
  mp->batches.assign(S, nullptr);
  mp->pslot.resize(S);
  mp->pre_exp.resize(S);

  std::vector<int32_t> shard_of((size_t)n);
  std::vector<int64_t> bytes_of((size_t)S, 0);
  for (int64_t i = 0; i < n; ++i) {
    uint64_t h = fnv1a64(keys + offsets[i], keys + offsets[i + 1]);
    int32_t s = (int32_t)(h % (uint64_t)S);
    shard_of[i] = s;
    counts[s]++;
    bytes_of[s] += offsets[i + 1] - offsets[i];
  }
  for (int64_t s = 0; s < S; ++s) {
    mp->skeys[s].reserve((size_t)bytes_of[s]);
    mp->soffs[s].reserve((size_t)counts[s] + 1);
    mp->soffs[s].push_back(0);
    mp->lanes[s].reserve((size_t)counts[s]);
  }
  for (int64_t i = 0; i < n; ++i) {
    int32_t s = shard_of[i];
    mp->skeys[s].insert(mp->skeys[s].end(), keys + offsets[i],
                        keys + offsets[i + 1]);
    mp->soffs[s].push_back((int64_t)mp->skeys[s].size());
    mp->lanes[s].push_back((int32_t)i);
  }
  return mp;
}

// Phase 2: per-shard grouped planning straight into padded [S, P]
// row-major outputs (callers pre-fill slot with -1 and the rest with 0;
// this writes only lanes [0, m_s) of each row).  Column inputs are
// FULL-batch arrays indexed by original lane.  pos[i] = s*P + j maps
// each original lane to its padded position, so numpy fills value/cfg
// columns with one vectorized scatter per column.  Returns n_rounds
// (max over shards).
int64_t gt_mesh_plan_grouped(void* mpv, const int32_t* algo,
                             const int32_t* behavior, const int64_t* hits,
                             const int64_t* limit, const int64_t* duration,
                             const int64_t* greg_e, const int64_t* greg_d,
                             int32_t reset_mask, int64_t P, int32_t* slot,
                             int32_t* rid, uint8_t* exists, int32_t* occ,
                             uint8_t* write, int64_t* pos) {
  MeshPlan* mp = (MeshPlan*)mpv;
  mp->P = P;
  int64_t n_rounds = 1;
  std::vector<int32_t> a32, b32, rid_t, slot_t, occ_t;
  std::vector<int64_t> h64, l64, d64, ge64, gd64;
  std::vector<uint8_t> ex_t, wr_t;
  for (int64_t s = 0; s < mp->S; ++s) {
    int64_t m = (int64_t)mp->lanes[s].size();
    if (m == 0) continue;
    // One shard's whole plan (batch begin + grouped plan + pre_exp
    // snapshot) runs under that shard's table lock: atomic against a
    // concurrent older batch's finish on the same shard (the
    // overlapped-pipeline contract; the gt_batch_* calls below
    // re-enter the same recursive mutex).
    GT_LOCK(mp->tables[s]);
    // Gather this shard's column values into contiguous temporaries.
    a32.resize(m); b32.resize(m);
    h64.resize(m); l64.resize(m); d64.resize(m);
    ge64.resize(m); gd64.resize(m);
    for (int64_t j = 0; j < m; ++j) {
      int32_t i = mp->lanes[s][j];
      a32[j] = algo[i]; b32[j] = behavior[i];
      h64[j] = hits[i]; l64[j] = limit[i]; d64[j] = duration[i];
      ge64[j] = greg_e[i]; gd64[j] = greg_d[i];
    }
    rid_t.assign(m, 0); slot_t.resize(m); occ_t.assign(m, 0);
    ex_t.resize(m); wr_t.resize(m);
    void* b = gt_batch_begin(mp->tables[s], mp->skeys[s].data(),
                             mp->soffs[s].data(), m, mp->now_ms);
    mp->batches[s] = b;
    int64_t nr = gt_batch_plan_grouped(
        b, a32.data(), b32.data(), h64.data(), l64.data(), d64.data(),
        ge64.data(), gd64.data(), reset_mask, rid_t.data(), slot_t.data(),
        ex_t.data(), occ_t.data(), wr_t.data());
    if (nr > n_rounds) n_rounds = nr;
    Table* t = mp->tables[s];
    int64_t base = s * P;
    mp->pslot[s].assign(slot_t.begin(), slot_t.end());
    mp->pre_exp[s].resize(m);
    for (int64_t j = 0; j < m; ++j) {
      slot[base + j] = slot_t[j];
      rid[base + j] = rid_t[j];
      exists[base + j] = ex_t[j];
      occ[base + j] = occ_t[j];
      write[base + j] = wr_t[j];
      pos[mp->lanes[s][j]] = base + j;
      // Plan-time expiry snapshot for the narrow keep-sentinel decode
      // (models/shard.py decode_narrow passthrough semantics).
      int32_t sl = slot_t[j];
      mp->pre_exp[s][j] =
          (sl >= 0 && sl < t->capacity) ? t->expire_ms[sl] : 0;
    }
  }
  return n_rounds;
}

// Phase 3 (narrow wire): decode the packed i32[S, 4, P] device result,
// commit each shard's plan into its slot table, and scatter responses
// into ORIGINAL-order output columns.  Sentinels (ops/buckets.py
// apply_rounds32): row2/row3 are deltas from now; -1 = absolute 0,
// -2 = unchanged pass-through (reconstructed from the live table when
// the slot still maps this lane's key, else the plan-time snapshot).
void gt_mesh_finish_narrow(void* mpv, const int32_t* packed, int64_t now_ms,
                           int32_t* status, int64_t* remaining,
                           int64_t* reset_time) {
  MeshPlan* mp = (MeshPlan*)mpv;
  int64_t P = mp->P;
  std::vector<int64_t> ne;
  std::vector<uint8_t> rm;
  for (int64_t s = 0; s < mp->S; ++s) {
    int64_t m = (int64_t)mp->lanes[s].size();
    if (m == 0) continue;
    Table* t = mp->tables[s];
    GT_LOCK(t);
    Batch* b = (Batch*)mp->batches[s];
    const int32_t* row0 = packed + ((s * 4) + 0) * P;
    const int32_t* row1 = packed + ((s * 4) + 1) * P;
    const int32_t* row2 = packed + ((s * 4) + 2) * P;
    const int32_t* row3 = packed + ((s * 4) + 3) * P;
    ne.resize(m);
    rm.resize(m);
    for (int64_t j = 0; j < m; ++j) {
      int32_t orig = mp->lanes[s][j];
      status[orig] = row0[j] & 1;
      rm[j] = (uint8_t)((row0[j] >> 1) & 1);
      remaining[orig] = (int64_t)row1[j];
      int32_t d2 = row2[j];
      if (d2 == -1) {
        reset_time[orig] = 0;
      } else if (d2 == -2) {
        // Keep-sentinel: prefer the live table value while the slot
        // still maps this lane's key (decode_narrow defense in depth).
        int32_t sl = mp->pslot[s][j];
        bool mine = sl >= 0 && sl < t->capacity && t->slot_mapped[sl] &&
                    t->slot_key[sl].compare(0, std::string::npos,
                                            b->key_ptr(j), b->key_len(j)) == 0;
        reset_time[orig] = mine ? t->expire_ms[sl] : mp->pre_exp[s][j];
      } else {
        reset_time[orig] = (int64_t)d2 + now_ms;
      }
      int32_t d3 = row3[j];
      // -1 decodes to absolute 0 (removed/no-reset; commit_plan WRITES
      // expire_ms=0); -2 decodes to -1 so commit_plan skips the
      // already-correct host value (unpack_output32 parity).
      ne[j] = (d3 == -1) ? 0 : (d3 == -2 ? -1 : (int64_t)d3 + now_ms);
    }
    gt_batch_commit_plan(b, ne.data(), rm.data());
  }
}

// Phase 3 (wide wire): same shape over the packed i64[S, 4, P] result
// with absolute values (ops/buckets.py _pack_output rows).
void gt_mesh_finish_wide(void* mpv, const int64_t* packed, int32_t* status,
                         int64_t* remaining, int64_t* reset_time) {
  MeshPlan* mp = (MeshPlan*)mpv;
  int64_t P = mp->P;
  std::vector<int64_t> ne;
  std::vector<uint8_t> rm;
  for (int64_t s = 0; s < mp->S; ++s) {
    int64_t m = (int64_t)mp->lanes[s].size();
    if (m == 0) continue;
    GT_LOCK(mp->tables[s]);
    Batch* b = (Batch*)mp->batches[s];
    const int64_t* row0 = packed + ((s * 4) + 0) * P;
    const int64_t* row1 = packed + ((s * 4) + 1) * P;
    const int64_t* row2 = packed + ((s * 4) + 2) * P;
    const int64_t* row3 = packed + ((s * 4) + 3) * P;
    ne.resize(m);
    rm.resize(m);
    for (int64_t j = 0; j < m; ++j) {
      int32_t orig = mp->lanes[s][j];
      status[orig] = (int32_t)(row0[j] & 1);
      rm[j] = (uint8_t)((row0[j] >> 1) & 1);
      remaining[orig] = row1[j];
      reset_time[orig] = row2[j];
      ne[j] = row3[j];
    }
    gt_batch_commit_plan(b, ne.data(), rm.data());
  }
}

void gt_mesh_free(void* mpv) {
  MeshPlan* mp = (MeshPlan*)mpv;
  for (void* b : mp->batches)
    if (b) gt_batch_free(b);
  delete mp;
}

}  // extern "C"
