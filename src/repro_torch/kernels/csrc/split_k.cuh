// Split-K plan shared by the kernels in this directory.
//
// When an output has too few tiles to fill the card (a decode projection
// with N = 2048 has 16 GEMV blocks on 132 SMs), the K loop is split over
// blocks: each split writes an fp32 partial sum, and a finishing kernel adds
// the splits in a fixed order. This is the one place that decides how many.

#pragma once

// The CUDA-core mappings (GEMV, tiled): several small blocks fit an SM.
constexpr int kBlocksPerSm = 4;     // aim for about this many blocks per SM
constexpr int kMinSplitRows = 128;  // no split shallower than this
// The tensor-core mapping: one block of 256 threads fills an SM's
// registers, and a split writes a whole [M, N] partial, so splits are few
// and deep.
constexpr int kMmaBlocksPerSm = 1;
constexpr int kMmaMinSplitRows = 256;

// Splits K over as many blocks as `tiles` output tiles need to give the card
// at most `blocks_per_sm` blocks per SM (one wave: a split that spills a few
// blocks into a second wave costs a whole one), each split a whole number of
// `k_step` rows, none shallower than `min_rows` (unless K is) and none
// empty. Writes the split count and the rows per split.
inline void plan_split_k(long long tiles, int K, int sms, int k_step,
                         int blocks_per_sm, int min_rows, int* splits,
                         int* k_per_split) {
  long long want = (long long)blocks_per_sm * sms / tiles;
  long long s = K / min_rows;
  if (want < s) s = want;
  if (s < 1) s = 1;
  int rows = (int)((K + s - 1) / s);
  rows = (rows + k_step - 1) / k_step * k_step;
  *k_per_split = rows;
  *splits = (K + rows - 1) / rows;
}
