// Row gather and row scatter of the persistence plane, on Hopper (sm_90a).
//
// Replaces the JAX package's row programs:
//   * gt_gather_rows (K7) — parallel/mesh.py::_gather_rows_mesh_jit and
//     the per-shard reads of _read_shard_rows, i.e. ops/buckets.py
//     read_rows: the hot and cold rows at each lane's (shard, slot),
//     composed into the seven logical columns (algo, status; limit,
//     remaining, duration, stamp, expire_at as int64 from lo/hi words).
//   * gt_write_rows (K8) — parallel/mesh.py::_write_rows_mesh_jit and
//     _write_row_jit, i.e. ops/buckets.py rows_to_split + write_rows:
//     each lane's logical row split into its hot and cold i32[8] rows and
//     written whole, spare words zero.
//
// What bounds them on this card: memory.  Per lane K7 reads 8 bytes of
// lane words and two 32-byte rows and writes 48 bytes of columns; K8
// reads the lane words and columns and writes the two rows.  The lanes
// are scattered over a table far larger than L2, so each row is its own
// 32-byte sector; the integer work is a few shifts.
//
// Design.  One thread per lane over a flat list of M lanes: one device
// holds every shard, so a batch needs no per-shard padding, and a lane
// names its shard.  Rows move as two 16-byte vector accesses each (the
// state is 16-byte aligned and a row is 32 bytes).  A lane whose shard
// or slot is out of range is padding: K7 writes zero columns for it
// (the JAX gather would read a wrapped row that no caller looks at) and
// K8 writes nothing (JAX's mode="drop").  K8 requires the in-range
// lanes to name distinct rows; the host keeps the last lane of each
// (ops/buckets.py last_lane_per_slot), so no two threads write one row.

#include <cuda_runtime.h>

#include <cstdint>

namespace gt {

constexpr int kRowThreads = 256;

__device__ __forceinline__ int64_t compose64(int32_t lo, int32_t hi) {
  return int64_t(uint64_t(uint32_t(hi)) << 32 | uint64_t(uint32_t(lo)));
}

__device__ __forceinline__ int32_t lo32(int64_t v) { return int32_t(uint32_t(uint64_t(v))); }

__device__ __forceinline__ int32_t hi32(int64_t v) { return int32_t(v >> 32); }

// The row of lane i, or -1 when the lane is padding.
__device__ __forceinline__ int64_t lane_row(const int32_t* lanes, int64_t M, int64_t i,
                                            int64_t S, int64_t C) {
  const int64_t s = lanes[i], c = lanes[M + i];
  return (s >= 0 && s < S && c >= 0 && c < C) ? s * C + c : -1;
}

__global__ void __launch_bounds__(kRowThreads)
gather_rows_kernel(const int32_t* __restrict__ hot, const int32_t* __restrict__ cold,
                   int64_t S, int64_t C, const int32_t* __restrict__ lanes, int64_t M,
                   int32_t* __restrict__ c32, int64_t* __restrict__ c64) {
  const int64_t i = int64_t(blockIdx.x) * kRowThreads + threadIdx.x;
  if (i >= M) return;
  const int64_t row = lane_row(lanes, M, i, S, C);
  int32_t flags = 0;
  int64_t limit = 0, rem = 0, dur = 0, stamp = 0, expire = 0;
  if (row >= 0) {
    const int4* h = reinterpret_cast<const int4*>(hot + row * 8);
    const int4 h0 = h[0], h1 = h[1];
    const int4 k0 = reinterpret_cast<const int4*>(cold + row * 8)[0];
    flags = h0.x;
    rem = compose64(h0.y, h0.z);
    stamp = compose64(h0.w, h1.x);
    expire = compose64(h1.y, h1.z);
    limit = compose64(k0.x, k0.y);
    dur = compose64(k0.z, k0.w);
  }
  c32[i] = flags & 3;
  c32[M + i] = (flags >> 2) & 1;
  c64[i] = limit;
  c64[M + i] = rem;
  c64[2 * M + i] = dur;
  c64[3 * M + i] = stamp;
  c64[4 * M + i] = expire;
}

__global__ void __launch_bounds__(kRowThreads)
write_rows_kernel(int32_t* __restrict__ hot, int32_t* __restrict__ cold, int64_t S,
                  int64_t C, const int32_t* __restrict__ lanes, int64_t M,
                  const int32_t* __restrict__ c32, const int64_t* __restrict__ c64) {
  const int64_t i = int64_t(blockIdx.x) * kRowThreads + threadIdx.x;
  if (i >= M) return;
  const int64_t row = lane_row(lanes, M, i, S, C);
  if (row < 0) return;
  const int32_t flags = (c32[i] & 3) | ((c32[M + i] & 1) << 2);
  const int64_t limit = c64[i], rem = c64[M + i], dur = c64[2 * M + i];
  const int64_t stamp = c64[3 * M + i], expire = c64[4 * M + i];
  int4* h = reinterpret_cast<int4*>(hot + row * 8);
  h[0] = make_int4(flags, lo32(rem), hi32(rem), lo32(stamp));
  h[1] = make_int4(hi32(stamp), lo32(expire), hi32(expire), 0);
  int4* k = reinterpret_cast<int4*>(cold + row * 8);
  k[0] = make_int4(lo32(limit), hi32(limit), lo32(dur), hi32(dur));
  k[1] = make_int4(0, 0, 0, 0);
}

inline unsigned row_blocks(int64_t n) { return unsigned((n + kRowThreads - 1) / kRowThreads); }

}  // namespace gt

extern "C" {

// K7: hot/cold i32[S, C, 8], lanes i32[2, M] (shard, slot); writes
// c32 i32[2, M] (algo, status) and c64 i64[5, M] (limit, remaining,
// duration, stamp, expire_at).  Returns cudaGetLastError().
int gt_gather_rows(const int32_t* hot, const int32_t* cold, int64_t S, int64_t C,
                   const int32_t* lanes, int64_t M, int32_t* c32, int64_t* c64,
                   void* stream) {
  if (M == 0) return 0;
  gt::gather_rows_kernel<<<gt::row_blocks(M), gt::kRowThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(hot, cold, S, C, lanes, M,
                                                                c32, c64);
  return int(cudaGetLastError());
}

// K8: the rows of c32/c64 (layout of K7's output) into hot/cold at
// lanes i32[2, M], in place.
int gt_write_rows(int32_t* hot, int32_t* cold, int64_t S, int64_t C, const int32_t* lanes,
                  int64_t M, const int32_t* c32, const int64_t* c64, void* stream) {
  if (M == 0) return 0;
  gt::write_rows_kernel<<<gt::row_blocks(M), gt::kRowThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(hot, cold, S, C, lanes, M,
                                                               c32, c64);
  return int(cudaGetLastError());
}

}  // extern "C"
