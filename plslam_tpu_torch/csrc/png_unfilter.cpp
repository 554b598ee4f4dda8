// Host helper of plslam_tpu_torch/io/imageio.py: undo one PNG row filter.
//
// PNG's Average (3) and Paeth (4) filters predict each byte from the byte
// bpp to its left in the SAME, already unfiltered row, so a row unfilters
// one pixel after another; numpy cannot vectorise that. imageio.py undoes
// filters 0-2 in numpy and calls this for 3 and 4 (it handles all five).
// Built at first use with the system's c++ into plslam_tpu_torch/_build/ and
// loaded with ctypes. Host code, not a device kernel: the reference decodes
// PNG on the host too (libpng in plslam_tpu/native/imagecodec.cpp).

#include <cstdint>
#include <cstdlib>

extern "C" {

// cur: n filtered bytes, unfiltered in place; prev: the previous row's n
// unfiltered bytes (zeros above the first row); bpp: bytes per complete
// pixel, at least 1. Returns 0, or -1 for an unknown filter type.
int png_unfilter_row(int ftype, uint8_t* cur, const uint8_t* prev, int n,
                     int bpp) {
  switch (ftype) {
    case 0:
      return 0;
    case 1:
      for (int i = bpp; i < n; ++i) cur[i] = (uint8_t)(cur[i] + cur[i - bpp]);
      return 0;
    case 2:
      for (int i = 0; i < n; ++i) cur[i] = (uint8_t)(cur[i] + prev[i]);
      return 0;
    case 3:
      for (int i = 0; i < n; ++i) {
        const int a = i >= bpp ? cur[i - bpp] : 0;
        cur[i] = (uint8_t)(cur[i] + ((a + prev[i]) >> 1));
      }
      return 0;
    case 4:
      for (int i = 0; i < n; ++i) {
        const int a = i >= bpp ? cur[i - bpp] : 0;
        const int b = prev[i];
        const int c = i >= bpp ? prev[i - bpp] : 0;
        const int p = a + b - c;
        const int pa = std::abs(p - a), pb = std::abs(p - b),
                  pc = std::abs(p - c);
        const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
        cur[i] = (uint8_t)(cur[i] + pred);
      }
      return 0;
    default:
      return -1;
  }
}

}  // extern "C"
