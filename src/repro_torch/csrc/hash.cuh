// The proposal hash of the push-relabel solvers, shared by every kernel
// that proposes (slack_propose, fused_assignment, fused_ot).
//
// It reproduces repro.core.matching._mix and proposal_keys: the key of
// (row i, column j, salt s) is mix(i*H1 + j*H2 + s*H3) in uint32
// arithmetic, where the salt of a propose round is phases*7919 + round.

#pragma once

#include <cstdint>

static constexpr uint32_t kH1 = 2654435761u;
static constexpr uint32_t kH2 = 2246822519u;
static constexpr uint32_t kH3 = 3266489917u;

static __device__ __forceinline__ uint32_t mix(uint32_t h) {
  h ^= h >> 15;
  h *= kH2;
  h ^= h >> 13;
  h *= kH3;
  return h ^ (h >> 16);
}

// The salt of round r of a phase: phases*7919 + r, wrapping as int32.
static __device__ __forceinline__ uint32_t round_salt(int phases, int r) {
  return (uint32_t)phases * 7919u + (uint32_t)r;
}
