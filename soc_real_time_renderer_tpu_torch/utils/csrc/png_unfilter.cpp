// PNG row unfiltering (the reconstruction of PNG spec section 9.2).
//
// Average and Paeth predict each byte from the reconstructed byte to its
// left, so a row is one dependent pass and cannot be vectorised in
// numpy; a 2048^2 RGBA map is 16 M such steps.  Built with g++ at first
// use by utils/png.py, which keeps a numpy version that the tests hold
// this one to, byte for byte.
#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" {

// src: `height` rows of (1 filter byte + `rowbytes` bytes); dst: height *
// rowbytes reconstructed bytes; bpp: bytes per complete pixel (>= 1).
// Returns 0, or 1 + the index of the first row with an unknown filter.
int64_t png_unfilter(const uint8_t* src, uint8_t* dst, int64_t height,
                     int64_t rowbytes, int64_t bpp) {
  for (int64_t y = 0; y < height; ++y) {
    const uint8_t* in = src + y * (rowbytes + 1);
    const int ft = in[0];
    ++in;
    uint8_t* out = dst + y * rowbytes;
    const uint8_t* prev = y > 0 ? out - rowbytes : nullptr;
    switch (ft) {
      case 0:
        std::memcpy(out, in, rowbytes);
        break;
      case 1:
        for (int64_t i = 0; i < rowbytes; ++i) {
          const int a = i >= bpp ? out[i - bpp] : 0;
          out[i] = static_cast<uint8_t>(in[i] + a);
        }
        break;
      case 2:
        for (int64_t i = 0; i < rowbytes; ++i) {
          const int b = prev ? prev[i] : 0;
          out[i] = static_cast<uint8_t>(in[i] + b);
        }
        break;
      case 3:
        for (int64_t i = 0; i < rowbytes; ++i) {
          const int a = i >= bpp ? out[i - bpp] : 0;
          const int b = prev ? prev[i] : 0;
          out[i] = static_cast<uint8_t>(in[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int64_t i = 0; i < rowbytes; ++i) {
          // the predictor works in int: p = a + b - c can leave 0..255
          const int a = i >= bpp ? out[i - bpp] : 0;
          const int b = prev ? prev[i] : 0;
          const int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
          const int p = a + b - c;
          const int pa = std::abs(p - a);
          const int pb = std::abs(p - b);
          const int pc = std::abs(p - c);
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          out[i] = static_cast<uint8_t>(in[i] + pred);
        }
        break;
      default:
        return y + 1;
    }
  }
  return 0;
}

}  // extern "C"
