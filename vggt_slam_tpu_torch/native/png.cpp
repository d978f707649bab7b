// The five PNG row filters undone, for data/images.py's reader: rows of a
// filter type byte and `stride` bytes, `bpp` bytes a pixel. Returns 0, or
// 1 + the first row whose type is above 4.
#include <cstdint>
#include <cstdlib>

extern "C" int32_t png_unfilter(const uint8_t* in, int32_t h, int32_t stride,
                                int32_t bpp, uint8_t* out) {
    for (int32_t y = 0; y < h; ++y) {
        const uint8_t* f = in + (size_t)y * (stride + 1) + 1;
        const int kind = f[-1];
        uint8_t* o = out + (size_t)y * stride;
        const uint8_t* up = y ? o - stride : nullptr;
        if (kind > 4) return y + 1;
        for (int32_t x = 0; x < stride; ++x) {
            const int a = x >= bpp ? o[x - bpp] : 0, b = up ? up[x] : 0,
                      c = up && x >= bpp ? up[x - bpp] : 0;
            int p = 0;
            if (kind == 1) p = a;
            else if (kind == 2) p = b;
            else if (kind == 3) p = (a + b) >> 1;
            else if (kind == 4) {
                const int pa = abs(b - c), pb = abs(a - c),
                          pc = abs(a + b - 2 * c);
                p = pa <= pb && pa <= pc ? a : pb <= pc ? b : c;
            }
            o[x] = (uint8_t)(f[x] + p);
        }
    }
    return 0;
}
