/* The plain reference's Δ seed for one level of the progressive kd-tree:
 * the upstream's running mean (AugmentariumLab/VolumeRenderer
 * VolumeKdTree_recover.cpp:254-267,415-455), one node after another, as the
 * sweep of encodeNodeEstimate is written there.  Built with the host's C
 * compiler by vrbench/reference_kd.py and called through ctypes.
 *
 * Node i's truth is truth[i] and its parent estimate parent[i >> shift].
 * Doubles throughout; no product is added to anything, so no multiply-add
 * can be contracted.  Writes {sum, count} into out[2]. */
#include <math.h>
#include <stdint.h>

void seed_level(const uint8_t* truth, const uint8_t* parent, int64_t n, int shift,
                double* out) {
  double sum = 0.0;
  double count = 0.0;
  for (int64_t i = 0; i < n; ++i) {
    const double t = truth[i];
    const double pe = parent[i >> shift];
    const double pd = fabs(pe - t);
    const double md = (sum + pd) / (count + 1.0);
    const double none_err = pd;
    const double add_err = fabs((pe + md > 255.0 ? 255.0 : pe + md) - t);
    const double sub_err = fabs((pe - md < 0.0 ? 0.0 : pe - md) - t);
    double min_err = none_err < add_err ? none_err : add_err;
    min_err = sub_err < min_err ? sub_err : min_err;
    if (min_err == none_err) continue; /* none beats add and sub on a tie */
    sum += pd;
    count += 1.0;
  }
  out[0] = sum;
  out[1] = count;
}
