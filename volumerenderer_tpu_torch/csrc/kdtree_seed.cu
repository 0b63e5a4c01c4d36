// The kd-tree codec's Δ-seeding sweep as compiled host code (no device code).
//
// Counterpart of volumerenderer_tpu/native/kdtree_native.cpp::seed_level_f64
// and of volumerenderer_tpu_torch/codecs/kdtree.py::_seed_level_py: the
// reference's level-order encodeNodeEstimate pass (VolumeKdTree_recover.cpp:
// 254-267,415-455) carries a running (sum, count) through every node of a
// level, so it cannot be split across threads.  A Python loop takes ~1.4 s
// per 2^20 nodes, ~48 s over the 2^25 nodes of a 256^3 tree; this loop takes
// a few ns per node.  Built by nvcc (through the host compiler) like the
// kernels and loaded with ctypes.
//
// Rounding: doubles throughout, in the Python loop's order.  No product is
// added to anything, so no multiply-add can be contracted: (sum, count) equal
// the Python loop's bit for bit.

#include <cmath>
#include <cstdint>

// Seeds one level of n nodes: truth[i] and parent[i] are exact byte values
// as doubles.  Writes {sum, count} into out[2].
extern "C" void kdtree_seed_level_f64(const double* truth, const double* parent, int64_t n,
                                      double* out) {
  double sum = 0.0;
  double count = 0.0;
  for (int64_t i = 0; i < n; ++i) {
    const double t = truth[i];
    const double pe = parent[i];
    const double pd = std::fabs(pe - t);
    const double md = (sum + pd) / (count + 1.0);
    const double none_err = pd;
    const double add_err = std::fabs((pe + md > 255.0 ? 255.0 : pe + md) - t);
    const double sub_err = std::fabs((pe - md < 0.0 ? 0.0 : pe - md) - t);
    double min_err = none_err < add_err ? none_err : add_err;
    min_err = sub_err < min_err ? sub_err : min_err;
    if (min_err == none_err) continue;  // tie order: none beats add and sub
    sum += pd;
    count += 1.0;
  }
  out[0] = sum;
  out[1] = count;
}
