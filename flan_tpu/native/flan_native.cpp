// flan_tpu native runtime: host-side codec hot loops.
//
// JAX replacement for the reference's native I/O dependencies
// (libsndfile decode/encode, reference AudioBuffer.cpp:70-190; the
// vendored bitmap_image BMP writer; the 24-bit .flan quantizer,
// PVBuffer.cpp:99-275). The device compute path is JAX/XLA; these are the
// byte-shuffling loops at the host boundary - interleave/deinterleave,
// PCM quantization, 24-bit packing - built as a small C ABI library and
// bound via ctypes (no pybind11 in the image).
//
// All functions use planar float32 [channels][frames] on the Python side.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <algorithm>

extern "C" {

// ---------------------------------------------------------------------------
// PCM decode: interleaved bytes -> planar float32
// fmt: 1 = pcm8, 2 = pcm16, 3 = pcm24, 4 = pcm32, 5 = float32, 6 = float64
// ---------------------------------------------------------------------------
int flan_decode_pcm(const uint8_t* raw, int64_t num_frames,
                    int32_t num_channels, int32_t fmt, float* out) {
    const int64_t total = num_frames * num_channels;
    for (int64_t i = 0; i < total; ++i) {
        const int64_t frame = i / num_channels;
        const int64_t ch = i % num_channels;
        float v = 0.0f;
        switch (fmt) {
            case 1:
                v = (static_cast<float>(raw[i]) - 128.0f) / 128.0f;
                break;
            case 2: {
                int16_t s;
                std::memcpy(&s, raw + 2 * i, 2);
                v = static_cast<float>(s) / 32768.0f;
                break;
            }
            case 3: {
                const uint8_t* p = raw + 3 * i;
                int32_t s = static_cast<int32_t>(p[0]) |
                            (static_cast<int32_t>(p[1]) << 8) |
                            (static_cast<int32_t>(p[2]) << 16);
                if (s & 0x800000) s |= 0xFF000000;
                v = static_cast<float>(s) / 8388608.0f;
                break;
            }
            case 4: {
                int32_t s;
                std::memcpy(&s, raw + 4 * i, 4);
                v = static_cast<float>(static_cast<double>(s)
                                       / 2147483648.0);
                break;
            }
            case 5: {
                std::memcpy(&v, raw + 4 * i, 4);
                break;
            }
            case 6: {
                double d;
                std::memcpy(&d, raw + 8 * i, 8);
                v = static_cast<float>(d);
                break;
            }
            default:
                return -1;
        }
        out[ch * num_frames + frame] = v;
    }
    return 0;
}

// ---------------------------------------------------------------------------
// PCM encode: planar float32 -> interleaved bytes
// ---------------------------------------------------------------------------
int flan_encode_pcm(const float* in, int64_t num_frames,
                    int32_t num_channels, int32_t fmt, uint8_t* out) {
    const int64_t total = num_frames * num_channels;
    for (int64_t i = 0; i < total; ++i) {
        const int64_t frame = i / num_channels;
        const int64_t ch = i % num_channels;
        const float raw_v = in[ch * num_frames + frame];
        const float v = std::min(1.0f, std::max(-1.0f, raw_v));
        switch (fmt) {
            case 2: {
                const double q = std::nearbyint(
                    static_cast<double>(v) * 32768.0);
                const int16_t s = static_cast<int16_t>(
                    std::min(32767.0, std::max(-32768.0, q)));
                std::memcpy(out + 2 * i, &s, 2);
                break;
            }
            case 3: {
                const double q = std::nearbyint(
                    static_cast<double>(v) * 8388608.0);
                const int32_t s = static_cast<int32_t>(
                    std::min(8388607.0, std::max(-8388608.0, q)));
                uint8_t* p = out + 3 * i;
                p[0] = static_cast<uint8_t>(s & 0xFF);
                p[1] = static_cast<uint8_t>((s >> 8) & 0xFF);
                p[2] = static_cast<uint8_t>((s >> 16) & 0xFF);
                break;
            }
            case 4: {
                const double q = std::nearbyint(
                    static_cast<double>(v) * 2147483648.0);
                const int32_t s = static_cast<int32_t>(std::min(
                    2147483647.0, std::max(-2147483648.0, q)));
                std::memcpy(out + 4 * i, &s, 4);
                break;
            }
            case 5: {
                std::memcpy(out + 4 * i, &raw_v, 4);
                break;
            }
            default:
                return -1;
        }
    }
    return 0;
}

// ---------------------------------------------------------------------------
// .flan 24-bit MF pack/unpack (reference PVBuffer.cpp:99-133, 254-275):
// values scaled to [-1, 1], quantized by 2^23 with truncation toward zero,
// little-endian 24-bit, interleaved (mag, freq) per bin.
// ---------------------------------------------------------------------------
int flan_pack_mf24(const float* mag, const float* freq, int64_t count,
                   float mag_scale, float freq_scale, uint8_t* out) {
    // Bit-exact with the reference save loop (PVBuffer.cpp:112-113):
    // float division, float clamp, THEN widen to double and scale.
    const double limit = 8388608.0;
    for (int64_t i = 0; i < count; ++i) {
        const float m = std::min(1.0f, std::max(-1.0f, mag[i] / mag_scale));
        const float f = std::min(1.0f, std::max(-1.0f, freq[i] / freq_scale));
        const int32_t mi = static_cast<int32_t>(
            static_cast<double>(m) * limit);
        const int32_t fi = static_cast<int32_t>(
            static_cast<double>(f) * limit);
        uint8_t* p = out + 6 * i;
        p[0] = mi & 0xFF; p[1] = (mi >> 8) & 0xFF; p[2] = (mi >> 16) & 0xFF;
        p[3] = fi & 0xFF; p[4] = (fi >> 8) & 0xFF; p[5] = (fi >> 16) & 0xFF;
    }
    return 0;
}

int flan_unpack_mf24(const uint8_t* raw, int64_t count, float mag_scale,
                     float freq_scale, float* mag, float* freq) {
    const double limit = 8388608.0;
    for (int64_t i = 0; i < count; ++i) {
        const uint8_t* p = raw + 6 * i;
        int32_t mi = static_cast<int32_t>(p[0]) |
                     (static_cast<int32_t>(p[1]) << 8) |
                     (static_cast<int32_t>(p[2]) << 16);
        int32_t fi = static_cast<int32_t>(p[3]) |
                     (static_cast<int32_t>(p[4]) << 8) |
                     (static_cast<int32_t>(p[5]) << 16);
        if (mi & 0x800000) mi |= 0xFF000000;
        if (fi & 0x800000) fi |= 0xFF000000;
        // Bit-exact with the reference load lambda (PVBuffer.cpp:260-266):
        // round to float BEFORE the float multiply by the scale.
        mag[i] = static_cast<float>(mi / limit) * mag_scale;
        freq[i] = static_cast<float>(fi / limit) * freq_scale;
    }
    return 0;
}

// ---------------------------------------------------------------------------
// BMP encode: RGB top-down [h][w][3] -> 24-bit bottom-up BGR rows with
// 4-byte row padding (replaces the vendored bitmap_image writer).
// Returns bytes written into out (caller sizes out as row_size * h).
// ---------------------------------------------------------------------------
int64_t flan_encode_bmp_rows(const uint8_t* rgb, int32_t width,
                             int32_t height, uint8_t* out) {
    const int64_t row_size = (3 * static_cast<int64_t>(width) + 3) & ~3LL;
    for (int32_t y = 0; y < height; ++y) {
        const uint8_t* src = rgb + static_cast<int64_t>(height - 1 - y)
                             * width * 3;
        uint8_t* dst = out + row_size * y;
        for (int32_t x = 0; x < width; ++x) {
            dst[3 * x + 0] = src[3 * x + 2];
            dst[3 * x + 1] = src[3 * x + 1];
            dst[3 * x + 2] = src[3 * x + 0];
        }
        for (int64_t x = 3 * width; x < row_size; ++x) dst[x] = 0;
    }
    return row_size * height;
}

}  // extern "C"
