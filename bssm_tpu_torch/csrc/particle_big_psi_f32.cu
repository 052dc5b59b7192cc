// The large-ensemble particle kernel in psi mode, float: one of the four
// instantiating sources of particle_big.cuh, compiled beside the others.
#include "particle_big.cuh"

int bssm_big_psi_f32(const BigLaunch& g) {
  return bssm::launch_big_mode<float, false>(g);
}
