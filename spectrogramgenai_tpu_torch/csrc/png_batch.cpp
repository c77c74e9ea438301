// Batch PNG codec for the host data path: grayscale decode for the training
// loaders, RGB encode for the spectrogram and generated-image writers and the
// server.
//
// Decode: a thread pool reads a batch of PNG files into a caller-owned uint8
// [n, H*W] buffer, as PIL's Image.open(path).convert("L"): gray and gray +
// alpha keep the gray byte; RGB, RGBA and palette colours become
// L = (R·19595 + G·38470 + B·7471 + 0x8000) >> 16, PIL's integer ITU-R 601-2
// rounding, so rows are bit-equal to PIL's. It reads 8-bit, non-interlaced
// PNGs of colour types 0, 2, 3, 4 and 6 with all five row filters; a palette
// index past the palette reads entry 0. Any other file (16-bit, interlaced, a
// size other than the one asked for, not a PNG, unreadable) reports ok = 0 and
// a zero row, and the caller decodes it another way.
//
// Encode: 8-bit RGB, each scanline Sub-filtered (filter byte 1, each byte minus
// the byte 3 to its left), deflated with zlib's compress2 at the given level
// into one IDAT chunk. In memory for the server, or one file per image.
//
// C ABI (ctypes):
//   int png_batch_load_gray(const char** paths, int n, unsigned char* out, long long out_stride,
//                           int expect_h, int expect_w, unsigned char* ok, int num_threads);
//   long long png_batch_encode_bound(int h, int w);
//   int png_batch_encode_rgb(const unsigned char* rgb, int n, int h, int w, unsigned char* out,
//                            long long capacity, long long* out_lens, int num_threads, int level);
//   int png_batch_save_rgb(const char** paths, int n, const unsigned char* rgb, int h, int w,
//                          unsigned char* ok, int num_threads, int level);
// Each returns the count of rows that succeeded. An encoded row that failed
// has out_lens[i] = -1 (ok[i] = 0 for a file).

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

#include <zlib.h>

namespace {

template <typename Fn>
int parallel_rows(int n, int num_threads, Fn fn) {
    if (n <= 0) return 0;
    std::atomic<int> next(0), good(0);
    auto run = [&]() {
        for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1))
            if (fn(i)) good.fetch_add(1);
    };
    const int workers = num_threads < 1 ? 1 : (num_threads < n ? num_threads : n);
    if (workers == 1) {
        run();
    } else {
        std::vector<std::thread> pool;
        pool.reserve(workers);
        for (int t = 0; t < workers; ++t) pool.emplace_back(run);
        for (auto& t : pool) t.join();
    }
    return good.load();
}

// ---- decode ---------------------------------------------------------------

struct Chunks {
    uint32_t width = 0, height = 0;
    uint8_t bit_depth = 0, color_type = 0, interlace = 1;
    std::vector<uint8_t> idat;
    std::vector<uint8_t> palette;  // RGB triples
};

uint32_t be32(const uint8_t* p) {
    return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) | (uint32_t(p[2]) << 8) | p[3];
}

bool read_file(const char* path, std::vector<uint8_t>* buf) {
    FILE* f = fopen(path, "rb");
    if (!f) return false;
    bool ok = fseek(f, 0, SEEK_END) == 0;
    const long size = ok ? ftell(f) : -1;
    ok = ok && size > 0 && fseek(f, 0, SEEK_SET) == 0;
    if (ok) {
        buf->resize(size_t(size));
        ok = fread(buf->data(), 1, size_t(size), f) == size_t(size);
    }
    fclose(f);
    return ok;
}

bool parse_chunks(const std::vector<uint8_t>& data, Chunks* out) {
    static const uint8_t sig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
    if (data.size() < 8 || memcmp(data.data(), sig, 8) != 0) return false;
    size_t pos = 8;
    bool saw_ihdr = false;
    while (pos + 8 <= data.size()) {
        const uint32_t len = be32(&data[pos]);
        if (pos + 12 + size_t(len) > data.size()) return false;
        const uint8_t* type = &data[pos + 4];
        const uint8_t* body = &data[pos + 8];
        if (memcmp(type, "IHDR", 4) == 0) {
            if (len != 13) return false;
            out->width = be32(body);
            out->height = be32(body + 4);
            out->bit_depth = body[8];
            out->color_type = body[9];
            out->interlace = body[12];
            saw_ihdr = true;
        } else if (memcmp(type, "PLTE", 4) == 0) {
            out->palette.assign(body, body + len);
        } else if (memcmp(type, "IDAT", 4) == 0) {
            out->idat.insert(out->idat.end(), body, body + len);
        } else if (memcmp(type, "IEND", 4) == 0) {
            break;
        }
        pos += 12 + size_t(len);  // length, type, body, CRC (not checked)
    }
    return saw_ihdr && !out->idat.empty();
}

bool inflate_idat(const std::vector<uint8_t>& idat, std::vector<uint8_t>* raw) {
    z_stream zs;
    memset(&zs, 0, sizeof(zs));
    if (inflateInit(&zs) != Z_OK) return false;
    zs.next_in = const_cast<Bytef*>(idat.data());
    zs.avail_in = uInt(idat.size());
    zs.next_out = raw->data();
    zs.avail_out = uInt(raw->size());
    const int rc = inflate(&zs, Z_FINISH);
    inflateEnd(&zs);
    return rc == Z_STREAM_END && zs.total_out == raw->size();
}

inline uint8_t paeth(int a, int b, int c) {
    const int p = a + b - c;
    const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
    if (pa <= pb && pa <= pc) return uint8_t(a);
    if (pb <= pc) return uint8_t(b);
    return uint8_t(c);
}

inline uint8_t rgb_to_l(uint8_t r, uint8_t g, uint8_t b) {
    return uint8_t((r * 19595u + g * 38470u + b * 7471u + 0x8000u) >> 16);
}

bool decode_gray(const char* path, uint8_t* out, int expect_h, int expect_w) {
    std::vector<uint8_t> file;
    if (!read_file(path, &file)) return false;
    Chunks c;
    if (!parse_chunks(file, &c)) return false;
    if (c.bit_depth != 8 || c.interlace != 0) return false;
    if (int64_t(c.height) != expect_h || int64_t(c.width) != expect_w) return false;
    int channels;
    switch (c.color_type) {
        case 0: channels = 1; break;  // gray
        case 2: channels = 3; break;  // RGB
        case 3: channels = 1; break;  // palette index
        case 4: channels = 2; break;  // gray + alpha
        case 6: channels = 4; break;  // RGBA
        default: return false;
    }
    if (c.color_type == 3 && c.palette.size() < 3) return false;

    const size_t stride = size_t(c.width) * channels;
    std::vector<uint8_t> raw(size_t(c.height) * (stride + 1));
    if (!inflate_idat(c.idat, &raw)) return false;
    std::vector<uint8_t> prev(stride, 0), cur(stride);
    const size_t bpp = size_t(channels);  // bytes a pixel at depth 8
    for (uint32_t y = 0; y < c.height; ++y) {
        const uint8_t* src = &raw[y * (stride + 1)];
        const uint8_t filter = *src++;
        switch (filter) {
            case 0:
                memcpy(cur.data(), src, stride);
                break;
            case 1:
                for (size_t x = 0; x < stride; ++x) cur[x] = uint8_t(src[x] + (x >= bpp ? cur[x - bpp] : 0));
                break;
            case 2:
                for (size_t x = 0; x < stride; ++x) cur[x] = uint8_t(src[x] + prev[x]);
                break;
            case 3:
                for (size_t x = 0; x < stride; ++x) {
                    const int left = x >= bpp ? cur[x - bpp] : 0;
                    cur[x] = uint8_t(src[x] + ((left + prev[x]) >> 1));
                }
                break;
            case 4:
                for (size_t x = 0; x < stride; ++x) {
                    const int left = x >= bpp ? cur[x - bpp] : 0;
                    const int up_left = x >= bpp ? prev[x - bpp] : 0;
                    cur[x] = uint8_t(src[x] + paeth(left, prev[x], up_left));
                }
                break;
            default:
                return false;
        }
        uint8_t* dst = out + size_t(y) * c.width;
        switch (c.color_type) {
            case 0:
                memcpy(dst, cur.data(), c.width);
                break;
            case 2:
                for (uint32_t x = 0; x < c.width; ++x) dst[x] = rgb_to_l(cur[3 * x], cur[3 * x + 1], cur[3 * x + 2]);
                break;
            case 3:
                for (uint32_t x = 0; x < c.width; ++x) {
                    size_t pi = size_t(cur[x]) * 3;
                    if (pi + 2 >= c.palette.size()) pi = 0;
                    dst[x] = rgb_to_l(c.palette[pi], c.palette[pi + 1], c.palette[pi + 2]);
                }
                break;
            case 4:
                for (uint32_t x = 0; x < c.width; ++x) dst[x] = cur[2 * x];
                break;
            case 6:
                for (uint32_t x = 0; x < c.width; ++x) dst[x] = rgb_to_l(cur[4 * x], cur[4 * x + 1], cur[4 * x + 2]);
                break;
        }
        std::swap(prev, cur);
    }
    return true;
}

// ---- encode ---------------------------------------------------------------

void put_be32(std::vector<uint8_t>* out, uint32_t v) {
    const uint8_t b[4] = {uint8_t(v >> 24), uint8_t(v >> 16), uint8_t(v >> 8), uint8_t(v)};
    out->insert(out->end(), b, b + 4);
}

void put_chunk(std::vector<uint8_t>* out, const char type[4], const uint8_t* data, size_t len) {
    put_be32(out, uint32_t(len));
    const size_t type_at = out->size();
    out->insert(out->end(), type, type + 4);
    if (len) out->insert(out->end(), data, data + len);
    put_be32(out, uint32_t(crc32(0L, out->data() + type_at, uInt(4 + len))));
}

constexpr long long kFraming = 8 + 25 + 12 + 12;  // signature, IHDR, IDAT's length/type/CRC, IEND

uLong raw_size(int h, int w) { return uLong(size_t(h) * (size_t(w) * 3 + 1)); }

bool encode_rgb_mem(const uint8_t* rgb, int h, int w, int level, std::vector<uint8_t>* png) {
    const size_t row = size_t(w) * 3;
    std::vector<uint8_t> raw(raw_size(h, w));
    for (int y = 0; y < h; ++y) {
        uint8_t* dst = raw.data() + size_t(y) * (row + 1);
        const uint8_t* src = rgb + size_t(y) * row;
        dst[0] = 1;  // Sub
        for (size_t x = 0; x < row; ++x) dst[1 + x] = uint8_t(src[x] - (x >= 3 ? src[x - 3] : 0));
    }
    uLongf deflated_len = compressBound(uLong(raw.size()));
    std::vector<uint8_t> deflated(deflated_len);
    if (compress2(deflated.data(), &deflated_len, raw.data(), uLong(raw.size()), level) != Z_OK) return false;

    png->clear();
    png->reserve(deflated_len + kFraming);
    static const uint8_t sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
    png->insert(png->end(), sig, sig + 8);
    const uint8_t ihdr[13] = {uint8_t(uint32_t(w) >> 24), uint8_t(uint32_t(w) >> 16), uint8_t(uint32_t(w) >> 8),
                              uint8_t(w), uint8_t(uint32_t(h) >> 24), uint8_t(uint32_t(h) >> 16),
                              uint8_t(uint32_t(h) >> 8), uint8_t(h),
                              8,  // bit depth
                              2,  // colour type RGB
                              0, 0, 0};
    put_chunk(png, "IHDR", ihdr, sizeof(ihdr));
    put_chunk(png, "IDAT", deflated.data(), deflated_len);
    put_chunk(png, "IEND", nullptr, 0);
    return true;
}

}  // namespace

extern "C" int png_batch_load_gray(const char** paths, int n, unsigned char* out, long long out_stride,
                                   int expect_h, int expect_w, unsigned char* ok, int num_threads) {
    return parallel_rows(n, num_threads, [&](int i) {
        uint8_t* dst = out + size_t(i) * size_t(out_stride);
        const bool success = decode_gray(paths[i], dst, expect_h, expect_w);
        if (!success) memset(dst, 0, size_t(expect_h) * size_t(expect_w));
        ok[i] = success ? 1 : 0;
        return success;
    });
}

// The most bytes one encoded (h, w) image can take: zlib's bound and the PNG framing.
extern "C" long long png_batch_encode_bound(int h, int w) {
    return (long long)compressBound(raw_size(h, w)) + kFraming;
}

extern "C" int png_batch_encode_rgb(const unsigned char* rgb, int n, int h, int w, unsigned char* out,
                                    long long capacity, long long* out_lens, int num_threads, int level) {
    const size_t img = size_t(h) * size_t(w) * 3;
    return parallel_rows(n, num_threads, [&](int i) {
        std::vector<uint8_t> png;
        const bool success = encode_rgb_mem(rgb + size_t(i) * img, h, w, level, &png) &&
                             (long long)png.size() <= capacity;
        if (success) memcpy(out + size_t(i) * size_t(capacity), png.data(), png.size());
        out_lens[i] = success ? (long long)png.size() : -1;
        return success;
    });
}

extern "C" int png_batch_save_rgb(const char** paths, int n, const unsigned char* rgb, int h, int w,
                                  unsigned char* ok, int num_threads, int level) {
    const size_t img = size_t(h) * size_t(w) * 3;
    return parallel_rows(n, num_threads, [&](int i) {
        std::vector<uint8_t> png;
        bool success = encode_rgb_mem(rgb + size_t(i) * img, h, w, level, &png);
        if (success) {
            FILE* f = fopen(paths[i], "wb");
            success = f != nullptr && fwrite(png.data(), 1, png.size(), f) == png.size();
            if (f != nullptr) success = (fclose(f) == 0) && success;
        }
        ok[i] = success ? 1 : 0;
        return success;
    });
}
