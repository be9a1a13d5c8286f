// audioio: host-side audio helpers of the port (a copy of the reference
// package's native/audioio.cpp, same functions, same arithmetic).
//
// The serving path's remaining host loops after the device work: the
// float32 -> int16 PCM conversion of decoded audio before it reaches the
// HTTP socket, the DC-block biquad and FLAC's frame CRC-16. A plain C ABI,
// loaded with ctypes (native/audioio.py builds it with g++ on first use).

#include <cstdint>
#include <cstddef>
#include <cmath>

extern "C" {

// Clamp float32 samples to [-1, 1] and convert to little-endian int16.
// dst must hold n int16 values. Returns n.
//
// Truncates toward zero (plain C cast), not round-to-nearest, so the bytes
// are identical to the NumPy path (utils/wav.py astype) and to the
// device-side conversion (runtime/generate.py decode_pcm16).
size_t pcm16_from_f32(const float* src, int16_t* dst, size_t n) {
    for (size_t i = 0; i < n; ++i) {
        float v = src[i];
        if (v > 1.0f) v = 1.0f;
        if (v < -1.0f) v = -1.0f;
        dst[i] = (int16_t)(v * 32767.0f);
    }
    return n;
}

// Peak-absolute value of a float32 buffer.
float peak_abs_f32(const float* src, size_t n) {
    float peak = 0.0f;
    for (size_t i = 0; i < n; ++i) {
        float v = src[i] < 0.0f ? -src[i] : src[i];
        if (v > peak) peak = v;
    }
    return peak;
}

// Direct-form-I biquad over float32 samples with float64 state: the
// sequential recursion behind --dc-block (the coefficients come from the
// Python caller). One pass, n multiply-adds.
size_t biquad_df1_f32(const float* src, float* dst, size_t n,
                      double b0, double b1, double b2, double a1, double a2) {
    double x1 = 0.0, x2 = 0.0, y1 = 0.0, y2 = 0.0;
    for (size_t i = 0; i < n; ++i) {
        const double xi = (double)src[i];
        const double yi = b0 * xi + b1 * x1 + b2 * x2 - a1 * y1 - a2 * y2;
        x2 = x1; x1 = xi;
        y2 = y1; y1 = yi;
        dst[i] = (float)yi;
    }
    return n;
}

// int16 -> float32 scaled by 1/32768 (WAV decode).
size_t f32_from_pcm16(const int16_t* src, float* dst, size_t n) {
    const float inv = 1.0f / 32768.0f;
    for (size_t i = 0; i < n; ++i) {
        dst[i] = (float)src[i] * inv;
    }
    return n;
}

}  // extern "C"

// CRC-16, polynomial 0x8005, MSB-first, init 0: the FLAC frame footer CRC
// (utils/flac.py), the same table algorithm as its Python loop. Thread-safe
// table initialization through a C++ function-local static.
namespace {
struct Crc16Table {
    uint16_t t[256];
    Crc16Table() {
        for (int i = 0; i < 256; ++i) {
            uint16_t c = (uint16_t)(i << 8);
            for (int b = 0; b < 8; ++b)
                c = (c & 0x8000) ? (uint16_t)((c << 1) ^ 0x8005)
                                 : (uint16_t)(c << 1);
            t[i] = c;
        }
    }
};
}  // namespace

extern "C" {

uint16_t crc16_8005(const uint8_t* data, size_t n) {
    static const Crc16Table table;
    uint16_t crc = 0;
    for (size_t i = 0; i < n; ++i)
        crc = (uint16_t)(table.t[((crc >> 8) ^ data[i]) & 0xFF]
                         ^ (uint16_t)(crc << 8));
    return crc;
}

}  // extern "C"
