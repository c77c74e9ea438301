// Batch WAV decoder and clip slicer for the host data path (gen_specs).
//
// A thread pool reads a batch of (file, begin, end) rows straight into a
// caller-owned float32 [n, stride] buffer: one 6-s window a row, mono.
// Every row is bit-equal to the package's Python path,
// audio/wavio.py load_wav + slice_clip (scipy.io.wavfile.read, then NumPy):
//   * PCM of 1-byte containers (bit depth <= 8) is unsigned: (u8 - 128) / 128;
//     2-, 3- and 4-byte containers are signed and scaled by 2^15, 2^31 (the
//     3-byte sample sits in the top of an int32, as scipy reads it) and 2^31;
//     5- to 8-byte containers are int64 and not scaled. IEEE float 32 and 64.
//     WAVE_FORMAT_EXTENSIBLE with a PCM or float subformat. Every sample is
//     converted to float32 with round to nearest, as NumPy's astype.
//   * Channels are mixed down as NumPy's float32 mean(axis=1): 0 plus NumPy's
//     pairwise sum of the row (sequential below 8 channels), then one division
//     by the channel count.
//   * The window: n = (long)(clip_seconds * sr) samples from begin * sr; if
//     that slice is not n long, the slice [max(0, end*sr - n), end*sr); Python
//     slice semantics throughout (negative ends count from the end, both ends
//     clamped to the clip); zero-padded to n. No clamp of end to the file's
//     length beyond what the slice does.
// Only the window's frames are read from the file, so a batch of rows from
// one long recording does not decode it once a row.
//
// Not read (the row reports rate 0, as an unreadable file): RIFX and RF64
// files, and headers scipy rejects or reads inconsistently (no fmt before
// data, sample rate or channel count 0, a PCM byte rate that is not rate ×
// block align, a container the bit depth does not fit, a truncated data chunk
// that does not end on a whole frame).
//
// C ABI (ctypes):
//   int wav_batch_rates(const char** paths, int n, int* rates, int num_threads);
//     rates[i] = the sample rate of a readable file, else 0; returns the count
//     of readable files.
//   int wav_batch_load(const char** paths, int n, const long long* begin_s,
//                      const long long* end_s, double clip_seconds, float* out,
//                      long long out_stride, int* rates, long long* lengths,
//                      int num_threads);
//     begin_s / end_s are the whole seconds int(begin_time), int(end_time).
//     Row i gets lengths[i] = (long)(clip_seconds * rate) samples, then zeros
//     up to out_stride; rates[i] = 0 and a zero row for a file that cannot be
//     read or whose window does not fit the stride. Returns the count of rows
//     read.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr uint16_t kPcm = 1, kFloat = 3, kExtensible = 0xFFFE;

struct WavInfo {
    uint16_t format = 0, channels = 0, bits = 0, block_align = 0;
    uint32_t rate = 0;
    long long data_offset = -1, data_bytes = 0;  // the last data chunk, as scipy keeps
    long long bytes_per_sample = 0, frames = 0;
};

uint16_t le16(const uint8_t* p) { return uint16_t(p[0] | (p[1] << 8)); }
uint32_t le32(const uint8_t* p) {
    return uint32_t(p[0]) | (uint32_t(p[1]) << 8) | (uint32_t(p[2]) << 16) | (uint32_t(p[3]) << 24);
}

// fmt chunk of `size` bytes at the file position, as scipy's _read_fmt_chunk.
bool read_fmt(FILE* f, uint32_t size, WavInfo* w) {
    if (size < 16) return false;
    uint8_t b[40];
    const uint32_t want = size < 40 ? size : 40;
    if (fread(b, 1, want, f) != want) return false;
    uint16_t format = le16(b);
    w->channels = le16(b + 2);
    w->rate = le32(b + 4);
    const uint32_t byte_rate = le32(b + 8);
    w->block_align = le16(b + 12);
    w->bits = le16(b + 14);
    if (format == kExtensible && size >= 18) {
        if (le16(b + 16) < 22 || size < 40) return false;
        // GUID {XXXXXXXX-0000-0010-8000-00AA00389B71}: the subformat is its first word
        static const uint8_t tail[12] = {0x00, 0x00, 0x10, 0x00, 0x80, 0x00, 0x00, 0xAA, 0x00, 0x38, 0x9B, 0x71};
        if (memcmp(b + 28, tail, 12) == 0) format = uint16_t(le32(b + 24));
        if (le32(b + 24) > 0xFFFF) return false;
    }
    if (format != kPcm && format != kFloat) return false;
    if (format == kPcm && uint64_t(byte_rate) != uint64_t(w->rate) * w->block_align) return false;
    w->format = format;
    return true;
}

// Walks the chunks as scipy.io.wavfile.read does; fills fmt and the data
// chunk's place. False for a file load_wav would not read (or this does not).
bool parse(FILE* f, WavInfo* w) {
    uint8_t head[12];
    if (fread(head, 1, 12, f) != 12 || memcmp(head, "RIFF", 4) != 0 || memcmp(head + 8, "WAVE", 4) != 0)
        return false;
    if (fseek(f, 0, SEEK_END) != 0) return false;
    const long long file_len = ftell(f);
    const long long riff_end = (long long)le32(head + 4) + 8;
    long long pos = 12;
    bool got_fmt = false;
    while (pos < riff_end) {
        uint8_t ch[8];
        if (fseek(f, pos, SEEK_SET) != 0) return false;
        const size_t got = fread(ch, 1, 8, f);
        if (got < 8) {  // the end of the file: fine once the data came, but not within a chunk's size
            if (got < 4 && w->data_offset >= 0) break;
            return false;
        }
        const uint32_t size = le32(ch + 4);
        if (memcmp(ch, "fmt ", 4) == 0) {
            if (!read_fmt(f, size, w)) return false;
            got_fmt = true;
        } else if (memcmp(ch, "data", 4) == 0) {
            if (!got_fmt) return false;
            w->data_offset = pos + 8;
            w->data_bytes = size;
        }
        pos += 8 + (long long)size + (size & 1);
    }
    if (!got_fmt || w->data_offset < 0 || w->rate == 0 || w->channels == 0) return false;
    const long long bps = w->block_align / w->channels;
    if (bps == 0) return false;
    if (w->format == kPcm) {
        if (w->bits == 0 || w->bits > 64) return false;
        if ((w->bits <= 8) != (bps == 1)) return false;  // a container the depth does not fit
    } else if (!((w->bits == 32 && bps == 4) || (w->bits == 64 && bps == 8))) {
        return false;
    }
    long long avail = file_len - w->data_offset;
    if (avail < 0) avail = 0;
    if (avail > w->data_bytes) avail = w->data_bytes;
    if ((bps == 3 || (bps >= 5 && bps <= 7)) && avail % bps != 0) return false;
    const long long samples = avail / bps;
    if (w->channels > 1 && samples % w->channels != 0) return false;
    w->bytes_per_sample = bps;
    w->frames = samples / w->channels;
    return true;
}

inline float sample(const uint8_t* p, const WavInfo& w) {
    const long long bps = w.bytes_per_sample;
    if (w.format == kFloat) {
        if (bps == 4) {
            float v;
            memcpy(&v, p, 4);
            return v;
        }
        double v;
        memcpy(&v, p, 8);
        return float(v);
    }
    switch (bps) {
        case 1: return (float(p[0]) - 128.0f) / 128.0f;
        case 2: {
            int16_t v;
            memcpy(&v, p, 2);
            return float(v) / 32768.0f;
        }
        case 3: {
            const int32_t v = int32_t(uint32_t(p[0]) << 8 | uint32_t(p[1]) << 16 | uint32_t(p[2]) << 24);
            return float(v) / 2147483648.0f;
        }
        case 4: {
            int32_t v;
            memcpy(&v, p, 4);
            return float(v) / 2147483648.0f;
        }
        default: {  // 5 to 8 bytes: an int64 with the sample in its top bytes, unscaled
            uint64_t u = 0;
            for (long long k = 0; k < bps; ++k) u |= uint64_t(p[k]) << (8 * (8 - bps + k));
            return float(int64_t(u));
        }
    }
}

// NumPy's pairwise float32 sum (numpy/_core/src/umath/loops_utils.h.src).
float pairwise_sum(const float* a, long long n) {
    if (n < 8) {
        float res = 0.0f;
        for (long long i = 0; i < n; ++i) res += a[i];
        return res;
    }
    if (n <= 128) {
        float r[8];
        for (int j = 0; j < 8; ++j) r[j] = a[j];
        long long i = 8;
        for (; i < n - (n % 8); i += 8)
            for (int j = 0; j < 8; ++j) r[j] += a[i + j];
        float res = ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5]) + (r[6] + r[7]));
        for (; i < n; ++i) res += a[i];
        return res;
    }
    long long n2 = n / 2;
    n2 -= n2 % 8;
    return pairwise_sum(a, n2) + pairwise_sum(a + n2, n - n2);
}

// Python's a[lo:hi] on a sequence of length len → [*lo, *hi).
void py_slice(long long lo, long long hi, long long len, long long* a, long long* b) {
    auto fix = [len](long long i) {
        if (i < 0) i += len;
        if (i < 0) i = 0;
        if (i > len) i = len;
        return i;
    };
    *a = fix(lo);
    *b = fix(hi);
    if (*b < *a) *b = *a;
}

bool load_row(const char* path, long long begin_s, long long end_s, double clip_seconds, float* out,
              long long stride, int* rate, long long* length) {
    FILE* f = fopen(path, "rb");
    if (!f) return false;
    WavInfo w;
    bool ok = parse(f, &w);
    const long long n = ok ? (long long)(clip_seconds * double(w.rate)) : 0;
    ok = ok && n >= 0 && n <= stride;
    long long a = 0, b = 0;
    if (ok) {
        py_slice(begin_s * (long long)w.rate, begin_s * (long long)w.rate + n, w.frames, &a, &b);
        if (b - a != n) {
            const long long end = end_s * (long long)w.rate;
            py_slice(end - n > 0 ? end - n : 0, end, w.frames, &a, &b);
        }
        ok = b - a <= n;  // only a negative end gives a longer slice
    }
    if (ok && b > a) {
        const long long frame_bytes = w.bytes_per_sample * w.channels;
        std::vector<uint8_t> raw((b - a) * frame_bytes);
        ok = fseek(f, w.data_offset + a * frame_bytes, SEEK_SET) == 0 &&
             fread(raw.data(), 1, raw.size(), f) == raw.size();
        if (ok) {
            std::vector<float> chans(w.channels);
            const float count = float(w.channels);
            for (long long i = 0; i < b - a; ++i) {
                const uint8_t* p = raw.data() + i * frame_bytes;
                if (w.channels == 1) {
                    out[i] = sample(p, w);
                    continue;
                }
                for (int c = 0; c < w.channels; ++c) chans[c] = sample(p + c * w.bytes_per_sample, w);
                out[i] = (0.0f + pairwise_sum(chans.data(), w.channels)) / count;
            }
        }
    }
    fclose(f);
    if (!ok) return false;
    memset(out + (b - a), 0, size_t(stride - (b - a)) * sizeof(float));
    *rate = int(w.rate);
    *length = n;
    return true;
}

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

}  // namespace

extern "C" int wav_batch_rates(const char** paths, int n, int* rates, int num_threads) {
    return parallel_rows(n, num_threads, [&](int i) {
        rates[i] = 0;
        FILE* f = fopen(paths[i], "rb");
        if (!f) return false;
        WavInfo w;
        if (parse(f, &w)) rates[i] = int(w.rate);
        fclose(f);
        return rates[i] != 0;
    });
}

extern "C" int wav_batch_load(const char** paths, int n, const long long* begin_s, const long long* end_s,
                              double clip_seconds, float* out, long long out_stride, int* rates,
                              long long* lengths, int num_threads) {
    return parallel_rows(n, num_threads, [&](int i) {
        float* row = out + (long long)i * out_stride;
        if (load_row(paths[i], begin_s[i], end_s[i], clip_seconds, row, out_stride, &rates[i], &lengths[i]))
            return true;
        memset(row, 0, size_t(out_stride) * sizeof(float));
        rates[i] = 0;
        lengths[i] = 0;
        return false;
    });
}
