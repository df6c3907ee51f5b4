// Native event-coordinate remapping kernel.
//
// TPU-build analogue of the reference's only first-party native module
// (`utils/modules_to_build/transformations`, imported as
// `utils.transformation.map` at reference utils/data.py:7 and used by the
// rotation augmentation at utils/data.py:213-216).
//
// Semantics (pinned by reference tests/dataset/test_dataset.py:122-170):
// given a pixel index mapping src_idx[i] -> dst_idx[i] over a raveled H*W
// grid, every event whose pixel appears in src_idx is rewritten to the
// mapped destination pixel; events at unmapped pixels are dropped.  Event
// rows are float32 with layout (x, y, t, p, ...extra columns preserved).
//
// Exposed with a C ABI for ctypes/cffi binding (no pybind11 in this image).

#include <cstddef>
#include <cstdint>
#include <vector>

extern "C" {

// Remap events through a pixel index mapping.
//
// events:      [n_events, n_cols] float32, columns (x, y, ...).
// height/width: grid shape used to ravel pixel indices (y * width + x).
// src_idx/dst_idx: [n_map] uint64 raveled pixel indices.
// out_events:  [n_events, n_cols] float32 output buffer (only the first
//              `return value` rows are written).
// Returns the number of surviving events, or -1 on error.
int64_t dvs_event_map(const float* events,
                      int64_t n_events,
                      int64_t n_cols,
                      int64_t height,
                      int64_t width,
                      const uint64_t* src_idx,
                      const uint64_t* dst_idx,
                      int64_t n_map,
                      float* out_events) {
  if (n_cols < 2 || height <= 0 || width <= 0) return -1;
  const int64_t n_pixels = height * width;
  // Pixel lookup table: src pixel -> dst pixel (-1 = unmapped).  Built once
  // per call; for repeated same-angle calls the caller should cache at a
  // higher level (the reference rebuilds per call as well).
  std::vector<int64_t> table(static_cast<size_t>(n_pixels), -1);
  for (int64_t i = 0; i < n_map; ++i) {
    const uint64_t s = src_idx[i];
    const uint64_t d = dst_idx[i];
    if (s >= static_cast<uint64_t>(n_pixels) ||
        d >= static_cast<uint64_t>(n_pixels))
      return -1;
    table[s] = static_cast<int64_t>(d);
  }

  int64_t n_out = 0;
  for (int64_t i = 0; i < n_events; ++i) {
    const float* row = events + i * n_cols;
    const int64_t x = static_cast<int64_t>(row[0]);
    const int64_t y = static_cast<int64_t>(row[1]);
    if (x < 0 || x >= width || y < 0 || y >= height) continue;
    const int64_t mapped = table[static_cast<size_t>(y * width + x)];
    if (mapped < 0) continue;
    float* out_row = out_events + n_out * n_cols;
    out_row[0] = static_cast<float>(mapped % width);
    out_row[1] = static_cast<float>(mapped / width);
    for (int64_t c = 2; c < n_cols; ++c) out_row[c] = row[c];
    ++n_out;
  }
  return n_out;
}

}  // extern "C"
