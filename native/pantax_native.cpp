// pantax_tpu native data plane: the host-side hot loops that feed the accelerator.
//
// The reference offloads this work to needletail/rust-htslib (SURVEY.md §2.1);
// here it is a small C++ library exposed through ctypes:
//   - fastx_parse:      FASTA/FASTQ buffer -> concatenated base codes +
//                       per-record offsets + id spans (single pass)
//   - kmer_hash_sample: rolling canonical k-mer hashing + open sampling,
//                       bit-identical to pantax_tpu.align.encode (the seed
//                       index build is O(k) numpy passes otherwise)
//
// Build: g++ -O3 -shared -fPIC pantax_native.cpp -o pantax_native.so
// (done on demand by pantax_tpu.utils.native).

#include <cstdint>
#include <cstddef>

extern "C" {

static inline int8_t base_code(uint8_t c) {
    switch (c) {
        case 'A': case 'a': return 0;
        case 'C': case 'c': return 1;
        case 'G': case 'g': return 2;
        case 'T': case 't': return 3;
        default: return 4;
    }
}

// Parse FASTA ('>') or FASTQ ('@') from a decompressed buffer.
// Outputs:
//   out_codes    [<= buf_len]       concatenated per-record base codes
//   out_offsets  [max_records + 1]  running offsets into out_codes
//   out_id_spans [2 * max_records]  (start, end) byte spans of ids in buf
// Returns the number of records parsed (< 0 on format error).
long long fastx_parse(
    const uint8_t* buf, long long len,
    int8_t* out_codes, long long* out_offsets,
    long long* out_id_spans, long long max_records)
{
    if (len == 0) return 0;
    const bool fastq = buf[0] == '@';
    if (!fastq && buf[0] != '>') return -1;

    long long pos = 0, n = 0, w = 0;
    out_offsets[0] = 0;
    while (pos < len && n < max_records) {
        if (buf[pos] != (fastq ? '@' : '>')) return -2;
        ++pos;
        long long id_start = pos;
        while (pos < len && buf[pos] != '\n' && buf[pos] != ' ' &&
               buf[pos] != '\t' && buf[pos] != '\r') ++pos;
        out_id_spans[2 * n] = id_start;
        out_id_spans[2 * n + 1] = pos;
        while (pos < len && buf[pos] != '\n') ++pos;  // rest of header
        ++pos;
        if (fastq) {
            while (pos < len && buf[pos] != '\n')
                out_codes[w++] = base_code(buf[pos++]);
            ++pos;                                        // end of seq line
            while (pos < len && buf[pos] != '\n') ++pos;  // '+' line
            ++pos;
            while (pos < len && buf[pos] != '\n') ++pos;  // quality line
            ++pos;
        } else {
            while (pos < len && buf[pos] != '>') {
                uint8_t c = buf[pos];
                if (c == '\n' || c == '\r') { ++pos; continue; }
                out_codes[w++] = base_code(c);
                ++pos;
            }
        }
        out_offsets[++n] = w;
    }
    return n;
}

static inline uint32_t mix32(uint32_t h) {
    h ^= h >> 16;
    h *= 0x85EBCA6Bu;
    h ^= h >> 13;
    h *= 0xC2B2AE35u;
    h ^= h >> 16;
    return h;
}

// Rolling canonical k-mer hashing with open sampling (single pass).
//   codes [n]: 0..3 bases, 4 invalid; k <= 64.
// Writes sampled (hash, position) pairs; returns their count.
// Matches pantax_tpu.align.encode exactly:
//   hf = sum_i c[p+i] * B^(k-1-i);  hr = sum_i (3-c[p+i]) * B^i  (mod 2^32)
//   key = mix32(min(hf, hr)); sampled iff key % 2^density_bits == 0.
// Rolling updates:
//   hf' = (hf - c_out * B^(k-1)) * B + c_in
//   hr' = (hr - (3 - c_out)) * invB + (3 - c_in) * B^(k-1)
// where invB is the modular inverse of B mod 2^32 (B odd).
long long kmer_hash_sample(
    const int8_t* codes, long long n, int k, int density_bits,
    uint32_t* out_hash, long long* out_pos, long long cap)
{
    if (n < k || k > 64) return 0;
    const uint32_t B = 0x9E3779B1u;
    uint32_t pows[64];
    pows[0] = 1;
    for (int i = 1; i < k; ++i) pows[i] = pows[i - 1] * B;
    uint32_t invB = B;  // Newton iteration: x *= 2 - B*x
    for (int it = 0; it < 5; ++it) invB *= 2u - B * invB;
    const uint32_t mask = (1u << density_bits) - 1u;

    uint32_t hf = 0, hr = 0;
    long long last_invalid = -1;
    for (int i = 0; i < k; ++i) {
        uint32_t c = (uint32_t)codes[i];
        if (codes[i] == 4) last_invalid = i;
        hf += c * pows[k - 1 - i];
        hr += (3u - c) * pows[i];
    }

    long long count = 0;
    for (long long p = 0; p + k <= n; ++p) {
        if (last_invalid < p) {
            uint32_t canon = hf < hr ? hf : hr;
            uint32_t key = mix32(canon);
            if ((key & mask) == 0) {
                if (count >= cap) return -count;  // caller retries with more
                out_hash[count] = key;
                out_pos[count] = p;
                ++count;
            }
        }
        if (p + k >= n) break;
        uint32_t c_out = (uint32_t)codes[p];
        uint32_t c_in = (uint32_t)codes[p + k];
        hf = (hf - c_out * pows[k - 1]) * B + c_in;
        hr = (hr - (3u - c_out)) * invB + (3u - c_in) * pows[k - 1];
        if (codes[p + k] == 4) last_invalid = p + k;
    }
    return count;
}

// 2-bit wire pack (align/aligner.py pack_codes2 parity): codes (0..4)
// row-major [B, L] -> packed uint8 [B, ceil(L/4)] plus the flat positions
// (padded [B, 4*ceil(L/4)] coordinates) of code-4 bases before each row's
// length.  Returns the exception count; -(count) when it exceeds cap (the
// caller falls back to the 4-bit pack); pads exc with the B*Lp sentinel.
// The Python pack costs ~53ms per 65536x160 batch and sits on the critical
// host path of the fused align loop; this is a single memory-bound pass.
long long pack_codes2_native(
    const int8_t* codes, long long B, long long L, const long long* lens,
    uint8_t* out, int32_t* exc, long long cap)
{
    const long long Lp = (L + 3) / 4 * 4;
    const long long W = Lp / 4;
    long long n_exc = 0;
    for (long long r = 0; r < B; ++r) {
        const int8_t* row = codes + r * L;
        const long long len = lens[r] < L ? lens[r] : L;
        uint8_t* orow = out + r * W;
        long long i = 0;
        for (; i + 4 <= L; i += 4) {
            orow[i >> 2] = (uint8_t)((row[i] & 3) | ((row[i + 1] & 3) << 2) |
                                     ((row[i + 2] & 3) << 4) |
                                     ((row[i + 3] & 3) << 6));
        }
        if (i < L) {
            uint8_t v = 0;
            for (long long j = i; j < L; ++j)
                v |= (uint8_t)((row[j] & 3) << (2 * (j - i)));
            orow[i >> 2] = v;
        }
        for (long long j = 0; j < len; ++j) {
            if (row[j] >= 4) {
                if (n_exc < cap) exc[n_exc] = (int32_t)(r * Lp + j);
                ++n_exc;
            }
        }
    }
    if (n_exc > cap) return -n_exc;
    for (long long t2 = n_exc; t2 < cap; ++t2)
        exc[t2] = (int32_t)(B * Lp);
    return n_exc;
}

}  // extern "C"

#include <algorithm>
#include <vector>

extern "C" {

// Unique k-mer positions (2-bit packed keys, k <= 31; k-mers containing N are
// skipped).  Sort-based: emits (key, pos) for k-mers occurring EXACTLY once,
// sorted by key.  Returns the count (<= cap; larger inputs return -needed).
// Replaces the per-genome Python dict scan in the anchor-partition pangenome
// constructor (graph/pangenome.py).
long long unique_kmer_positions(
    const int8_t* codes, long long n, int k,
    uint64_t* out_key, long long* out_pos, long long cap)
{
    if (n < k || k > 31) return 0;
    std::vector<std::pair<uint64_t, long long>> kp;
    kp.reserve((size_t)(n - k + 1));
    const uint64_t mask = (k == 32) ? ~0ull : ((1ull << (2 * k)) - 1);
    uint64_t cur = 0;
    long long last_invalid = -1;
    for (long long i = 0; i < n; ++i) {
        uint64_t c = (uint64_t)codes[i];
        if (codes[i] == 4) { last_invalid = i; c = 0; }
        cur = ((cur << 2) | c) & mask;
        long long p = i - k + 1;
        if (p >= 0 && last_invalid < p)
            kp.emplace_back(cur, p);
    }
    std::sort(kp.begin(), kp.end());
    long long count = 0;
    size_t m = kp.size();
    for (size_t i = 0; i < m;) {
        size_t j = i + 1;
        while (j < m && kp[j].first == kp[i].first) ++j;
        if (j == i + 1) {
            if (count >= cap) { ++count; i = j; continue; }
            out_key[count] = kp[i].first;
            out_pos[count] = kp[i].second;
            ++count;
        }
        i = j;
    }
    return count <= cap ? count : -count;
}

}  // extern "C"

extern "C" {

// CHD-style displacement-hash placement of n DISTINCT uint32 keys into an
// open table of 2^Tb slots, with per-bucket displacements (bucket = top mb
// key bits; 2^mb buckets, ~1 key each).  Greedy per bucket: the first d
// whose slots mix32(key ^ d*GOLD) & (T-1) are all free and pairwise
// distinct wins.  Writes each key's slot (out_slot, int64 [n]) and the
// displacement array (out_disp, int32 [2^mb]); returns 0, or -1 when any
// bucket exhausts d < 2^16 (caller falls back to bisection lookup).
// Mirrors the NumPy fallback in align/aligner.py:_build_chd (any valid
// placement is equivalent — the device lookup only needs table/disp to be
// mutually consistent).
long long chd_build(
    const uint32_t* keys, long long n, int mb, int Tb,
    long long* out_slot, int32_t* out_disp)
{
    const uint32_t GOLD = 0x9E3779B9u;
    const long long m = 1LL << mb;
    const long long T = 1LL << Tb;
    const uint32_t mask = (uint32_t)(T - 1);
    const int shift = 32 - mb;

    // counting sort of key indices by bucket
    std::vector<long long> start(m + 1, 0);
    for (long long i = 0; i < n; ++i)
        ++start[(keys[i] >> shift) + 1];
    for (long long b = 0; b < m; ++b) start[b + 1] += start[b];
    std::vector<long long> korder(n);
    {
        std::vector<long long> cur(start.begin(), start.begin() + m);
        for (long long i = 0; i < n; ++i)
            korder[cur[keys[i] >> shift]++] = i;
    }

    std::vector<uint8_t> occ(T, 0);
    uint32_t slots[64];
    for (long long b = 0; b < m; ++b) {
        const long long s = start[b], e = start[b + 1];
        out_disp[b] = 0;
        if (s == e) continue;
        if (e - s > 64) return -1;
        const int w = (int)(e - s);
        bool placed = false;
        for (uint32_t d = 1; d < (1u << 16); ++d) {
            const uint32_t salt = GOLD * d;
            bool ok = true;
            for (int j = 0; j < w && ok; ++j) {
                const uint32_t sl = mix32(keys[korder[s + j]] ^ salt) & mask;
                if (occ[sl]) { ok = false; break; }
                for (int j2 = 0; j2 < j; ++j2)
                    if (slots[j2] == sl) { ok = false; break; }
                slots[j] = sl;
            }
            if (ok) {
                for (int j = 0; j < w; ++j) {
                    occ[slots[j]] = 1;
                    out_slot[korder[s + j]] = (long long)slots[j];
                }
                out_disp[b] = (int32_t)d;
                placed = true;
                break;
            }
        }
        if (!placed) return -1;
    }
    return 0;
}

}  // extern "C"
