// PNG row reconstruction (the five filter types of the PNG specification,
// section 9) for fourm_torch/data/image_io.py: the inflated IDAT stream of
// a non-interlaced 8-bit image, one filter byte before each row, becomes
// the raw rows. Sub, Average and Paeth depend on the byte to the left, so
// Python would walk them byte by byte.
//
// Exposed C ABI (bound in fourm_torch/native/__init__.py):
//   png_unfilter(in, height, rowbytes, bpp, out) -> 0, or -(row + 1) for a
//   row whose filter byte is not 0..4
//   in: height * (rowbytes + 1) bytes; out: height * rowbytes bytes

#include <cstdint>
#include <cstdlib>

extern "C" int64_t png_unfilter(const uint8_t* in, int64_t height, int64_t rowbytes,
                                int64_t bpp, uint8_t* out) {
  for (int64_t r = 0; r < height; r++) {
    const uint8_t* src = in + r * (rowbytes + 1);
    const uint8_t ft = src[0];
    src++;
    uint8_t* dst = out + r * rowbytes;
    const uint8_t* up = r > 0 ? out + (r - 1) * rowbytes : nullptr;
    for (int64_t i = 0; i < rowbytes; i++) {
      const int a = i >= bpp ? dst[i - bpp] : 0;
      const int b = up != nullptr ? up[i] : 0;
      const int c = (up != nullptr && i >= bpp) ? up[i - bpp] : 0;
      int pred;
      switch (ft) {
        case 0: pred = 0; break;
        case 1: pred = a; break;
        case 2: pred = b; break;
        case 3: pred = (a + b) >> 1; break;
        case 4: {
          const int p = a + b - c;
          const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
          pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          break;
        }
        default: return -(r + 1);
      }
      dst[i] = (uint8_t)((src[i] + pred) & 0xFF);
    }
  }
  return 0;
}
