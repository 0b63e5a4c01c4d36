// The kd-tree codec's Δ-seeding sweep as compiled host code (no device code).
//
// Counterpart of volumerenderer_tpu/native/kdtree_native.cpp::seed_level_f64
// and of volumerenderer_tpu_torch/codecs/kdtree.py::_seed_level_py: the
// reference's level-order encodeNodeEstimate pass (VolumeKdTree_recover.cpp:
// 254-267,415-455) carries a running (sum, count) through every node of a
// level.  A Python loop takes ~1.4 s per 2^20 nodes; that loop compiled takes
// ~16 ns a node on the H100's host, a division and a branch the data decide
// between one node and the next (71 s over the 2^32 nodes of a 2048x2048x512
// tree).  Built by nvcc (through the host compiler) like the kernels and
// loaded with ctypes.
//
// It reads the level's own arrays: the truth bytes and the parent estimates
// (bytes or int32), node i's estimate at parent[i >> shift], so a level
// seeds from its parent level's recon (shift 1) with no copy.
//
// The sweep gives the loop's (sum, count) bit for bit with few divisions.
// Every pd = |pe - t| is an integer <= 255, so the loop's double sum and
// count are exact integers (below 2^53), kept here as int64.  A node joins
// the mean (add or sub chosen) iff its add error (t > pe) or its sub error
// (t < pe) is below pd; that error is a non-decreasing function of the mean
// md, composed of correctly rounded operations, so the md at which a node
// joins form an interval, and for pd >= 1 it holds md = 1 (an estimate one
// step toward t).  In a block of nodes a node's md lies between lo[pd], the
// mean at the least sum and the most count the block can reach, and hi[pd],
// at the most sum and the least count.  Where lo[pd] >= 1 and the node's
// decision is the same at lo[pd] and at hi[pd], it is the same at every md
// between, the loop's md included; else the node divides as the loop does,
// from the exact state.  A block spans a 256th of the count so far (4096 to
// 2^22 nodes), so its band of md is narrow and few nodes divide; a block
// works out the decisions at lo and hi once for each (t, pe) it holds.
//
// Rounding: doubles throughout, each expression as in the Python loop.  No
// product is added to anything, so no multiply-add can be contracted.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <vector>

namespace {

// The loop's decision at node (t, pe), pd = |pe - t|, at the mean md: true
// when add or sub is chosen (the node joins the mean), false for none.  The
// loop asks min(sub_err, min(none_err, add_err)) == none_err; the errors are
// finite and >= 0, so that is none_err <= add_err and none_err <= sub_err.
inline bool joins(double t, double pe, double pd, double md) {
  const double add_err = std::fabs((pe + md > 255.0 ? 255.0 : pe + md) - t);
  const double sub_err = std::fabs((pe - md < 0.0 ? 0.0 : pe - md) - t);
  return (add_err < pd) | (sub_err < pd);
}

constexpr int64_t kMinBlock = 4096;
constexpr int64_t kMaxBlock = int64_t{1} << 22;

// Node i's parent estimate is parent[i >> shift].
template <typename P>
void seed_level(const uint8_t* truth, const P* parent, int64_t n, int shift, double* out) {
  int64_t sum = 0, count = 0;
  double lo[256], hi[256];
  std::vector<uint8_t> table(256 * 256);
  for (int64_t i = 0; i < n;) {
    int64_t block = count >> 8;
    block = block < kMinBlock ? kMinBlock : (block > kMaxBlock ? kMaxBlock : block);
    const int64_t end = n - i < block ? n : i + block;
    // the block's pd, all of them: the most it can add to sum (< 255 * 2^22)
    int32_t most = 0;
    for (int64_t j = i; j < end; ++j)
      most += std::abs(static_cast<int32_t>(parent[j >> shift]) - static_cast<int32_t>(truth[j]));
    const double s_lo = static_cast<double>(sum), s_hi = static_cast<double>(sum + most);
    const double c_lo = static_cast<double>(count);
    const double c_hi = static_cast<double>(count + (end - i));
    for (int pd = 0; pd < 256; ++pd) {
      lo[pd] = (s_lo + pd) / (c_hi + 1.0);
      hi[pd] = (s_hi + pd) / (c_lo + 1.0);
    }
    auto flag = [&](int t, int pe) {
      const int k = std::abs(pe - t);  // pd 0: none is chosen at any mean
      const double pd = k;
      const bool join = joins(t, pe, pd, lo[k]);
      const bool fixed = (k == 0) | ((lo[k] >= 1.0) & (join == joins(t, pe, pd, hi[k])));
      return static_cast<uint8_t>(join | (fixed << 1));
    };
    // the block's decisions by (t, pe), each worked out at its first node
    // (the nodes of a level hold few distinct pairs): join in bit 0, fixed
    // by the band in bit 1, 0xff not yet worked out
    std::fill(table.begin(), table.end(), uint8_t{0xff});
    for (int64_t j = i; j < end; ++j) {
      const int t = truth[j], pe = static_cast<int>(parent[j >> shift]);
      uint8_t f = table[t * 256 + pe];
      if (f == 0xff) f = table[t * 256 + pe] = flag(t, pe);
      const int64_t k = std::abs(pe - t);
      int64_t join = f & 1;
      if (!(f & 2)) {  // the band holds the node's edge: the loop's own division
        const double md = (static_cast<double>(sum) + k) / (static_cast<double>(count) + 1.0);
        join = joins(t, pe, k, md);
      }
      // masks, not a branch: the data decide join, and a mispredicted branch
      // a node would cost more than the rest of its work
      sum += k & -join;
      count += join;
    }
    i = end;
  }
  out[0] = static_cast<double>(sum);
  out[1] = static_cast<double>(count);
}

}  // namespace

// Seeds one level of n nodes: truth[i] bytes, the parent estimate of node i
// parent[i >> shift] (shift 0: one estimate a node; 1: the parent level's
// recon, one a pair of children).  Writes {sum, count} into out[2].
extern "C" void kdtree_seed_level_u8(const uint8_t* truth, const uint8_t* parent, int64_t n,
                                     int shift, double* out) {
  seed_level(truth, parent, n, shift, out);
}

extern "C" void kdtree_seed_level_i32(const uint8_t* truth, const int32_t* parent, int64_t n,
                                      int shift, double* out) {
  seed_level(truth, parent, n, shift, out);
}
