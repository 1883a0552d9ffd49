// K6 local and K7 local: the column passes of one shard's block of the
// d-way sharded four-step of n = n1*n2 points (parallel/sharded_fft.py).
//
// Replaces dsc_tpu/fourier/pallas_stream.py's two per-shard sites:
//   K6 _phase_a_kernel at phase_a_local_p (:753) -> stream_phase_a_local:
//       the shard's (n1, n2/d) column block x, columns col0 .. col0 + m - 1
//       of the whole (n1, n2) matrix -> z (m, n1),
//       z[j, k1] = W_n^(s*k1*(col0 + j)) * sum_j1 x[j1, j] W_n1^(s*j1*k1)
//   K7 _phase_b_kernel at phase_b_local_p (:792) -> stream_phase_b_local:
//       the exchanged (n2, n1/d) block z -> X of the same shape,
//       X[k2, j] = scale * sum_j2 z[j2, j] W_n2^(s*j2*k2), scale 1/n (the
//       whole n) on the inverse, complex64 or the float32 real part
// with s = -1 forward and +1 inverse, the tables of the whole n-point plan
// (fourier/plan.py StreamTables). Both are the cluster column pass of
// cluster_columns.cuh, whose note gives the design, its bound and its
// limits: groups of W = 8 columns held across a cluster of Q = max(1,
// L/1024) CTAs, P = L/Q rows a CTA, loaded by TMA into a two-stage ring,
// the column FFT split over the cluster by decimation, the clusters
// persistent. The geometry comes from the caller (fourier/stream.py
// local_geometry) and is checked here: a launch outside it, a block that is
// not 16-byte aligned or a tensor map that cannot be encoded returns an
// error and launches nothing.

#include "cluster_columns.cuh"

using namespace dsc;

namespace {

using Launch = int (*)(const void*, void*, int, int, int, int, int, const void*, const void*,
                       const void*, int, float, int, void*);
using Info = int (*)(int, int, int, int, int*);

// [inverse][real input] of K6 local, [inverse][real output] of K7 local
constexpr Launch kPhaseA[2][2] = {
    {launch_cluster_columns<false, false, true, false>,
     launch_cluster_columns<false, true, true, false>},
    {launch_cluster_columns<true, false, true, false>,
     launch_cluster_columns<true, true, true, false>}};
constexpr Launch kPhaseB[2][2] = {
    {launch_cluster_columns<false, false, false, false>,
     launch_cluster_columns<false, false, false, true>},
    {launch_cluster_columns<true, false, false, false>,
     launch_cluster_columns<true, false, false, true>}};
constexpr Info kInfo[2][2][2] = {
    {{cluster_info<false, false, true, false>, cluster_info<false, true, true, false>},
     {cluster_info<true, false, true, false>, cluster_info<true, true, true, false>}},
    {{cluster_info<false, false, false, false>, cluster_info<false, false, false, true>},
     {cluster_info<true, false, false, false>, cluster_info<true, false, false, true>}}};

}  // namespace

extern "C" {

// x: (n1, m) float32 (real_input) or complex64 -> z (m, n1) complex64;
// w_n1: n1/2 stage twiddles W_n1^p; tw_lo/hi/bits: W_n factored (the
// whole n); columns, cluster, clusters: W, Q and the clusters in the grid
int dsc_stream_phase_a_local(const void* x, void* z, int n1, int m, int col0, int real_input,
                             int inverse, const void* w_n1, const void* tw_lo,
                             const void* tw_hi, int tw_bits, int columns, int cluster,
                             int clusters, void* stream) {
  return kPhaseA[inverse != 0][real_input != 0](x, z, n1, m, columns, cluster, clusters, w_n1,
                                                tw_lo, tw_hi, tw_bits, 1.f, col0, stream);
}

// z: (n2, m) complex64 -> out (n2, m), complex64 or the float32 real part
// (real_output); w_n2: n2/2 stage twiddles W_n2^p; scale: 1/n or 1;
// columns, cluster, clusters: W, Q and the clusters in the grid
int dsc_stream_phase_b_local(const void* z, void* out, int n2, int m, int inverse,
                             int real_output, const void* w_n2, float scale, int columns,
                             int cluster, int clusters, void* stream) {
  return kPhaseB[inverse != 0][real_output != 0](z, out, n2, m, columns, cluster, clusters, w_n2,
                                                 nullptr, nullptr, 0, scale, 0, stream);
}

// What a launch of K6 local (phase_b 0; flag: real input) or K7 local
// (phase_b 1; flag: real output) over an (L, m) block at this geometry
// gets on the current device: info[0] clusters active at once, info[1]
// registers a thread, info[2] local memory a thread, info[3] shared memory
// a CTA, info[4] threads a CTA (cluster_columns.cuh cluster_info)
int dsc_stream_local_info(int phase_b, int flag, int inverse, int L, int m, int columns,
                          int cluster, int* info) {
  return kInfo[phase_b != 0][inverse != 0][flag != 0](L, m, columns, cluster, info);
}

}  // extern "C"
