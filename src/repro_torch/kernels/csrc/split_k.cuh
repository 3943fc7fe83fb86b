// Split-K plan shared by the kernels in this directory.
//
// When an output has too few tiles to fill the card (a decode projection
// with N = 2048 has 16 GEMV blocks on 132 SMs), the K loop is split over
// blocks: each split writes an fp32 partial sum, and a finishing kernel adds
// the splits in a fixed order. This is the one place that decides how many.

#pragma once

constexpr int kBlocksPerSm = 4;     // aim for about this many blocks per SM
constexpr int kMinSplitRows = 128;  // no split shallower than this

// Splits K over enough blocks that `tiles` output tiles give the card about
// kBlocksPerSm blocks per SM, each split a whole number of `k_step` rows and
// none empty. Writes the split count and the rows per split.
inline void plan_split_k(long long tiles, int K, int sms, int k_step,
                         int* splits, int* k_per_split) {
  long long want = ((long long)kBlocksPerSm * sms + tiles - 1) / tiles;
  long long s = K / kMinSplitRows;
  if (want < s) s = want;
  if (s < 1) s = 1;
  int rows = (int)((K + s - 1) / s);
  rows = (rows + k_step - 1) / k_step * k_step;
  *k_per_split = rows;
  *splits = (K + rows - 1) / rows;
}
