// Native FLAC decoder (format per the FLAC specification / RFC 9639).
//
// The reference reads challenge corpora through libsndfile (soundfile), which
// decodes FLAC (utils/resample_to_estimated_bandwidth.py:59-61 writes .flac;
// DNS5/CommonVoice sources ship flac).  This build image has no libsndfile,
// so the hot decode path is implemented here; a pure-python fallback (and the
// encoder) lives in urgent2026_challenge_track1_tpu_torch/utils/flac.py.
//
// Exported (C ABI, used via ctypes):
//   flac_probe(buf, n, info[4])          -> 0 ok; info = {total_samples,
//                                           sample_rate, channels, bits}
//   flac_decode(buf, n, out, cap, done)  -> 0 ok; out = interleaved int32
//                                           (raw right-justified samples at
//                                           source bit depth), done = frames
//
// Build: g++ -O3 -shared -fPIC -o libflac_native.so flac_native.cpp

#include <cstdint>
#include <cstring>

namespace {

struct BitReader {
    const uint8_t* buf;
    int64_t nbytes;
    int64_t pos;   // byte position
    int bit;       // bit position inside byte (0 = MSB)
    bool error;

    explicit BitReader(const uint8_t* b, int64_t n)
        : buf(b), nbytes(n), pos(0), bit(0), error(false) {}

    bool eof() const { return pos >= nbytes; }

    void align() {
        if (bit) { bit = 0; ++pos; }
    }

    uint64_t read(int n) {  // up to 57 bits
        uint64_t v = 0;
        while (n > 0) {
            if (pos >= nbytes) { error = true; return 0; }
            int avail = 8 - bit;
            int take = n < avail ? n : avail;
            int shift = avail - take;
            v = (v << take) | ((buf[pos] >> shift) & ((1u << take) - 1u));
            bit += take;
            if (bit == 8) { bit = 0; ++pos; }
            n -= take;
        }
        return v;
    }

    int64_t read_signed(int n) {
        uint64_t v = read(n);
        if (n == 0) return 0;
        if (v & (1ull << (n - 1))) return (int64_t)(v - (1ull << n));
        return (int64_t)v;
    }

    // count 0 bits until the terminating 1 bit
    uint32_t read_unary() {
        uint32_t q = 0;
        for (;;) {
            if (pos >= nbytes) { error = true; return 0; }
            uint8_t cur = (uint8_t)(buf[pos] << bit);
            if (cur == 0) {
                q += 8 - bit;
                bit = 0;
                ++pos;
                continue;
            }
            int lead = __builtin_clz((uint32_t)cur) - 24;  // zeros in this byte
            q += lead;
            bit += lead + 1;
            if (bit >= 8) { bit -= 8; ++pos; }
            return q;
        }
    }
};

uint16_t crc16(const uint8_t* data, int64_t n) {  // CRC-16/BUYPASS, poly 0x8005
    uint16_t c = 0;
    for (int64_t i = 0; i < n; ++i) {
        c ^= (uint16_t)(data[i] << 8);
        for (int b = 0; b < 8; ++b)
            c = (c & 0x8000) ? (uint16_t)((c << 1) ^ 0x8005) : (uint16_t)(c << 1);
    }
    return c;
}


// frame-header UTF-8-style coded number (up to 36 bits / 7 bytes)
uint64_t read_utf8(BitReader& br) {
    uint64_t b0 = br.read(8);
    if (b0 < 0x80) return b0;
    int n = 0;
    uint64_t mask = 0x40;
    while (b0 & mask) { ++n; mask >>= 1; }
    uint64_t v = b0 & (mask - 1);
    for (int i = 0; i < n; ++i) v = (v << 6) | (br.read(8) & 0x3F);
    return v;
}

bool decode_residual(BitReader& br, int order, int blocksize, int64_t* res) {
    int method = (int)br.read(2);
    if (method > 1) return false;
    int plen = method == 0 ? 4 : 5;
    uint32_t escape = method == 0 ? 0xF : 0x1F;
    int porder = (int)br.read(4);
    int nparts = 1 << porder;
    int psize = blocksize >> porder;
    if (psize <= 0 || (blocksize % nparts) != 0) return false;
    int idx = order;  // residuals follow the warmup samples in `res`
    for (int p = 0; p < nparts; ++p) {
        int count = psize - (p == 0 ? order : 0);
        if (count < 0) return false;
        uint32_t param = (uint32_t)br.read(plen);
        if (param == escape) {
            int bits = (int)br.read(5);
            for (int i = 0; i < count; ++i) res[idx++] = br.read_signed(bits);
        } else {
            for (int i = 0; i < count; ++i) {
                uint64_t q = br.read_unary();
                uint64_t lo = br.read((int)param);
                uint64_t v = (q << param) | lo;
                res[idx++] = (int64_t)(v >> 1) ^ -(int64_t)(v & 1);
            }
        }
        if (br.error) return false;
    }
    return true;
}

bool decode_subframe(BitReader& br, int blocksize, int bps, int64_t* out) {
    if (br.read(1) != 0) return false;  // zero pad bit
    int type = (int)br.read(6);
    int wasted = 0;
    if (br.read(1)) wasted = 1 + (int)br.read_unary();
    if (wasted > 32) return false;  // malformed: shift would be UB
    bps -= wasted;
    if (bps <= 0 || bps > 33) return false;

    if (type == 0) {  // CONSTANT
        int64_t v = br.read_signed(bps);
        for (int i = 0; i < blocksize; ++i) out[i] = v;
    } else if (type == 1) {  // VERBATIM
        for (int i = 0; i < blocksize; ++i) out[i] = br.read_signed(bps);
    } else if (type >= 8 && type <= 12) {  // FIXED, order 0-4
        int order = type - 8;
        for (int i = 0; i < order; ++i) out[i] = br.read_signed(bps);
        if (!decode_residual(br, order, blocksize, out)) return false;
        switch (order) {
            case 0:
                break;
            case 1:
                for (int i = 1; i < blocksize; ++i) out[i] += out[i - 1];
                break;
            case 2:
                for (int i = 2; i < blocksize; ++i)
                    out[i] += 2 * out[i - 1] - out[i - 2];
                break;
            case 3:
                for (int i = 3; i < blocksize; ++i)
                    out[i] += 3 * out[i - 1] - 3 * out[i - 2] + out[i - 3];
                break;
            case 4:
                for (int i = 4; i < blocksize; ++i)
                    out[i] += 4 * out[i - 1] - 6 * out[i - 2] + 4 * out[i - 3] -
                              out[i - 4];
                break;
        }
    } else if (type >= 32) {  // LPC, order 1-32
        int order = (type & 31) + 1;
        for (int i = 0; i < order; ++i) out[i] = br.read_signed(bps);
        int prec = (int)br.read(4) + 1;
        if (prec == 16) return false;  // 0b1111 invalid
        int shift = (int)br.read_signed(5);
        if (shift < 0) return false;
        int64_t coef[32];
        for (int i = 0; i < order; ++i) coef[i] = br.read_signed(prec);
        if (!decode_residual(br, order, blocksize, out)) return false;
        for (int i = order; i < blocksize; ++i) {
            int64_t acc = 0;
            for (int j = 0; j < order; ++j) acc += coef[j] * out[i - 1 - j];
            out[i] += acc >> shift;
        }
    } else {
        return false;  // reserved
    }
    if (wasted)
        for (int i = 0; i < blocksize; ++i) out[i] <<= wasted;
    return !br.error;
}

struct StreamInfo {
    int64_t total_samples;
    int sample_rate, channels, bits;
    int64_t frames_start;  // byte offset of first audio frame
};

bool parse_streaminfo(const uint8_t* buf, int64_t n, StreamInfo* si) {
    if (n < 42 || memcmp(buf, "fLaC", 4) != 0) return false;
    BitReader br(buf, n);
    br.read(32);  // magic
    bool last = false;
    bool have = false;
    while (!last && !br.error) {
        last = br.read(1) != 0;
        int type = (int)br.read(7);
        int64_t len = (int64_t)br.read(24);
        if (type == 0) {
            BitReader m(buf + br.pos, len);
            m.read(16 + 16 + 24 + 24);  // block/frame size bounds
            si->sample_rate = (int)m.read(20);
            si->channels = (int)m.read(3) + 1;
            si->bits = (int)m.read(5) + 1;
            si->total_samples = (int64_t)m.read(36);
            have = true;
        }
        br.pos += len;
        if (br.pos > n) return false;
    }
    si->frames_start = br.pos;
    return have && !br.error;
}

}  // namespace

extern "C" {

int flac_probe(const uint8_t* buf, int64_t n, int64_t* info) {
    StreamInfo si;
    if (!parse_streaminfo(buf, n, &si)) return -1;
    info[0] = si.total_samples;
    info[1] = si.sample_rate;
    info[2] = si.channels;
    info[3] = si.bits;
    return 0;
}

int flac_decode(const uint8_t* buf, int64_t n, int32_t* out,
                int64_t cap_frames, int64_t* decoded_frames) {
    StreamInfo si;
    if (!parse_streaminfo(buf, n, &si)) return -1;
    BitReader br(buf, n);
    br.pos = si.frames_start;
    int64_t done = 0;
    static thread_local int64_t* chan[8] = {nullptr};
    static thread_local int64_t chan_cap = 0;

    while (br.pos < n && !br.error) {
        // frame header (byte-aligned)
        int64_t frame_start = br.pos;
        if ((uint32_t)br.read(14) != 0x3FFE) break;  // sync
        br.read(1);                                  // reserved
        br.read(1);                                  // blocking strategy
        int bs_code = (int)br.read(4);
        int sr_code = (int)br.read(4);
        int ch_asgn = (int)br.read(4);
        int ss_code = (int)br.read(3);
        br.read(1);  // reserved
        read_utf8(br);
        int blocksize;
        switch (bs_code) {
            case 0: return -2;
            case 1: blocksize = 192; break;
            case 6: blocksize = (int)br.read(8) + 1; break;
            case 7: blocksize = (int)br.read(16) + 1; break;
            default:
                blocksize = bs_code < 6 ? (576 << (bs_code - 2))
                                        : (256 << (bs_code - 8));
        }
        if (sr_code == 12) br.read(8);
        else if (sr_code == 13 || sr_code == 14) br.read(16);
        int bps;
        switch (ss_code) {
            case 0: bps = si.bits; break;
            case 1: bps = 8; break;
            case 2: bps = 12; break;
            case 4: bps = 16; break;
            case 5: bps = 20; break;
            case 6: bps = 24; break;
            case 7: bps = 32; break;
            default: return -2;
        }
        br.read(8);  // header CRC-8 (not verified)
        if (br.error) break;

        int nch = ch_asgn < 8 ? ch_asgn + 1 : 2;
        if (nch != si.channels || nch > 8) return -3;
        if (blocksize > chan_cap) {
            for (int c = 0; c < 8; ++c) { delete[] chan[c]; chan[c] = nullptr; }
            chan_cap = blocksize < 65536 ? 65536 : blocksize;
            for (int c = 0; c < nch; ++c) chan[c] = new int64_t[chan_cap];
        }
        for (int c = 0; c < nch; ++c) {
            if (!chan[c]) chan[c] = new int64_t[chan_cap];
            int sub_bps = bps;
            if ((ch_asgn == 8 && c == 1) || (ch_asgn == 9 && c == 0) ||
                (ch_asgn == 10 && c == 1))
                sub_bps += 1;  // side channel carries one extra bit
            if (!decode_subframe(br, blocksize, sub_bps, chan[c])) return -4;
        }
        br.align();
        uint16_t want = crc16(buf + frame_start, br.pos - frame_start);
        uint16_t got = (uint16_t)br.read(16);
        if (br.error) break;
        if (got != want) return -6;  // frame CRC-16 mismatch (corrupt data)

        // stereo decorrelation
        if (ch_asgn == 8) {  // left/side: R = L - S
            for (int i = 0; i < blocksize; ++i) chan[1][i] = chan[0][i] - chan[1][i];
        } else if (ch_asgn == 9) {  // right/side: L = R + S
            for (int i = 0; i < blocksize; ++i) {
                int64_t r = chan[1][i];
                chan[1][i] = r;
                chan[0][i] = chan[0][i] + r;
            }
        } else if (ch_asgn == 10) {  // mid/side
            for (int i = 0; i < blocksize; ++i) {
                int64_t mid = chan[0][i], side = chan[1][i];
                mid = (mid << 1) | (side & 1);
                chan[0][i] = (mid + side) >> 1;
                chan[1][i] = (mid - side) >> 1;
            }
        }

        int64_t take = blocksize;
        if (done + take > cap_frames) take = cap_frames - done;
        for (int64_t i = 0; i < take; ++i)
            for (int c = 0; c < nch; ++c)
                out[(done + i) * nch + c] = (int32_t)chan[c][i];
        done += take;
        if (done >= cap_frames) break;
    }
    *decoded_frames = done;
    return done > 0 ? 0 : -5;
}

}  // extern "C"
