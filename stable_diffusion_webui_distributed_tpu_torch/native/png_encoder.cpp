// Native PNG encoder for the serving path.
//
// Every image leaves the server as a base64 PNG (webui's wire format).
// Encoding it with PIL costs tens of milliseconds per large image on one
// host core, on the request path, after the card has finished. This
// encoder writes RGB8/RGBA8 PNGs straight through zlib with filter-0
// scanlines; runtime/native.py builds it at first use and loads it with
// ctypes, and falls back to PIL only when it cannot be built.
//
// Build: g++ -O3 -shared -fPIC png_encoder.cpp -lz -o libpng_encoder.so

#include <cstdint>
#include <cstring>
#include <vector>
#include <zlib.h>

namespace {

inline void put_be32(std::vector<uint8_t>& out, uint32_t v) {
    out.push_back((v >> 24) & 0xff);
    out.push_back((v >> 16) & 0xff);
    out.push_back((v >> 8) & 0xff);
    out.push_back(v & 0xff);
}

void put_chunk(std::vector<uint8_t>& out, const char type[4],
               const uint8_t* data, size_t len) {
    put_be32(out, static_cast<uint32_t>(len));
    size_t start = out.size();
    out.insert(out.end(), type, type + 4);
    if (len) out.insert(out.end(), data, data + len);
    uint32_t crc = crc32(0L, Z_NULL, 0);
    crc = crc32(crc, out.data() + start, static_cast<uInt>(4 + len));
    put_be32(out, crc);
}

}  // namespace

extern "C" {

// Encode HxW pixels with `channels` (3=RGB, 4=RGBA) 8-bit samples.
// Returns the number of bytes written to `out` (capacity `out_cap`),
// 0 on failure, or the required capacity as a negative number if `out`
// is too small.
long sdtpu_encode_png(const uint8_t* pixels, int width, int height,
                      int channels, int compression_level,
                      uint8_t* out, long out_cap) {
    if (width <= 0 || height <= 0 || (channels != 3 && channels != 4))
        return 0;
    const size_t stride = static_cast<size_t>(width) * channels;

    // raw stream: one filter byte (0 = None) per scanline
    std::vector<uint8_t> raw;
    raw.reserve((stride + 1) * height);
    for (int y = 0; y < height; ++y) {
        raw.push_back(0);
        const uint8_t* row = pixels + static_cast<size_t>(y) * stride;
        raw.insert(raw.end(), row, row + stride);
    }

    uLongf comp_cap = compressBound(static_cast<uLong>(raw.size()));
    std::vector<uint8_t> comp(comp_cap);
    if (compress2(comp.data(), &comp_cap, raw.data(),
                  static_cast<uLong>(raw.size()),
                  compression_level) != Z_OK)
        return 0;
    comp.resize(comp_cap);

    std::vector<uint8_t> png;
    png.reserve(comp.size() + 128);
    static const uint8_t sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a,
                                   '\n'};
    png.insert(png.end(), sig, sig + 8);

    uint8_t ihdr[13];
    ihdr[0] = (width >> 24) & 0xff; ihdr[1] = (width >> 16) & 0xff;
    ihdr[2] = (width >> 8) & 0xff;  ihdr[3] = width & 0xff;
    ihdr[4] = (height >> 24) & 0xff; ihdr[5] = (height >> 16) & 0xff;
    ihdr[6] = (height >> 8) & 0xff;  ihdr[7] = height & 0xff;
    ihdr[8] = 8;                              // bit depth
    ihdr[9] = (channels == 3) ? 2 : 6;        // color type: RGB / RGBA
    ihdr[10] = 0; ihdr[11] = 0; ihdr[12] = 0; // deflate/adaptive/no-interlace
    put_chunk(png, "IHDR", ihdr, sizeof(ihdr));
    put_chunk(png, "IDAT", comp.data(), comp.size());
    put_chunk(png, "IEND", nullptr, 0);

    if (static_cast<long>(png.size()) > out_cap)
        return -static_cast<long>(png.size());
    std::memcpy(out, png.data(), png.size());
    return static_cast<long>(png.size());
}

}  // extern "C"
