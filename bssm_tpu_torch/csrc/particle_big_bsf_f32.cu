// The large-ensemble particle kernel in bsf mode, float: one of the four
// instantiating sources of particle_big.cuh, compiled beside the others.
#include "particle_big.cuh"

int bssm_big_bsf_f32(const BigLaunch& g) {
  return bssm::launch_big_mode<float, true>(g);
}
