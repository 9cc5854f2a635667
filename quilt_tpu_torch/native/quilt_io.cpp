// quilt_io: native host data plane for quilt_tpu.
//
// TPU-native equivalent of the reference's native IO layer (STITCH's
// C++/htslib loadBamAndConvert and vcfpp-based Rcpp_get_hap_info_from_vcf;
// see SURVEY.md section 2.9): BGZF decompression, reference-panel VCF
// ingestion straight to bit-packed haplotype words, and BAM read extraction
// to (SNP index, signed base quality) arrays with mate merging.
//
// Exposed as a C ABI consumed through ctypes (quilt_tpu/io/native.py);
// no htslib/pybind11 dependency — zlib only.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

#include <zlib.h>

extern "C" {

// ---------------------------------------------------------------------------
// BGZF / gzip decompression
// ---------------------------------------------------------------------------

struct QioBuffer {
    std::vector<uint8_t> data;
};

// Decompress a BGZF or plain-gzip file fully into memory.
// Returns opaque handle (nullptr on failure).
void* qio_read_gzip(const char* path) {
    FILE* fh = fopen(path, "rb");
    if (!fh) return nullptr;
    std::vector<uint8_t> comp;
    {
        fseek(fh, 0, SEEK_END);
        long sz = ftell(fh);
        fseek(fh, 0, SEEK_SET);
        comp.resize(sz);
        if (sz > 0 && fread(comp.data(), 1, sz, fh) != (size_t)sz) {
            fclose(fh);
            return nullptr;
        }
    }
    fclose(fh);
    auto* out = new QioBuffer();
    if (comp.size() >= 2 && comp[0] == 0x1f && comp[1] == 0x8b) {
        // gzip members (BGZF = concatenated members); inflate all
        z_stream zs;
        memset(&zs, 0, sizeof(zs));
        if (inflateInit2(&zs, 15 + 32) != Z_OK) { delete out; return nullptr; }
        size_t in_off = 0;
        std::vector<uint8_t> chunk(1 << 20);
        while (in_off < comp.size()) {
            zs.next_in = comp.data() + in_off;
            zs.avail_in = comp.size() - in_off;
            int ret = Z_OK;
            while (ret != Z_STREAM_END) {
                zs.next_out = chunk.data();
                zs.avail_out = chunk.size();
                ret = inflate(&zs, Z_NO_FLUSH);
                if (ret != Z_OK && ret != Z_STREAM_END) {
                    inflateEnd(&zs);
                    delete out;
                    return nullptr;
                }
                out->data.insert(out->data.end(), chunk.data(),
                                 chunk.data() + (chunk.size() - zs.avail_out));
                if (ret == Z_OK && zs.avail_in == 0 && zs.avail_out != 0) break;
            }
            in_off = comp.size() - zs.avail_in;
            if (ret == Z_STREAM_END) {
                if (inflateReset2(&zs, 15 + 32) != Z_OK) break;
                if (zs.avail_in == 0) break;
            }
        }
        inflateEnd(&zs);
    } else {
        out->data = std::move(comp);
    }
    return out;
}

int64_t qio_buffer_size(void* h) {
    return ((QioBuffer*)h)->data.size();
}

const uint8_t* qio_buffer_data(void* h) {
    return ((QioBuffer*)h)->data.data();
}

void qio_buffer_free(void* h) {
    delete (QioBuffer*)h;
}

}  // extern "C" (reopened after the internal streaming/index machinery)

// ---------------------------------------------------------------------------
// Streaming BGZF reader with virtual-offset seek (htslib-equivalent core).
// Replaces whole-file inflation: blocks decompress on demand, so a region
// query against an indexed multi-GB BAM/VCF touches only its blocks
// (reference gets this via htslib inside STITCH; SURVEY.md 2.9,
// QUILT/R/quilt.R:237-238).
// ---------------------------------------------------------------------------

namespace {

struct BgzfReader {
    FILE* fh = nullptr;
    int mode = 0;                 // 0=plain file, 1=BGZF, 2=gzip stream
    std::vector<uint8_t> ubuf;    // current uncompressed block
    size_t upos = 0;
    int64_t block_coffset = 0;    // compressed offset of current block
    int64_t next_coffset = 0;
    z_stream zs;                  // mode 2 only
    bool zs_live = false;
    std::vector<uint8_t> gz_in;
    bool at_eof = false;

    ~BgzfReader() {
        if (zs_live) inflateEnd(&zs);
        if (fh) fclose(fh);
    }
};

// Load the BGZF block at compressed offset `coffset`. Returns false at EOF
// or on a malformed block.
static bool bgzf_load_block(BgzfReader& r, int64_t coffset) {
    if (fseek(r.fh, (long)coffset, SEEK_SET) != 0) return false;
    uint8_t hdr[12];
    if (fread(hdr, 1, 12, r.fh) != 12) return false;
    if (hdr[0] != 0x1f || hdr[1] != 0x8b || hdr[2] != 8 || !(hdr[3] & 4))
        return false;
    int xlen = hdr[10] | (hdr[11] << 8);
    std::vector<uint8_t> extra(xlen);
    if ((int)fread(extra.data(), 1, xlen, r.fh) != xlen) return false;
    int bsize = -1;
    for (int i = 0; i + 4 <= xlen;) {
        int slen = extra[i + 2] | (extra[i + 3] << 8);
        if (extra[i] == 'B' && extra[i + 1] == 'C' && slen == 2)
            bsize = (extra[i + 4] | (extra[i + 5] << 8)) + 1;
        i += 4 + slen;
    }
    if (bsize < 0) return false;
    int comp_len = bsize - 12 - xlen - 8;
    if (comp_len < 0) return false;
    std::vector<uint8_t> comp(comp_len + 8);
    if ((int)fread(comp.data(), 1, comp_len + 8, r.fh) != comp_len + 8)
        return false;
    uint32_t isize;
    memcpy(&isize, comp.data() + comp_len + 4, 4);
    r.ubuf.resize(isize);
    if (isize > 0) {
        z_stream bz;
        memset(&bz, 0, sizeof(bz));
        if (inflateInit2(&bz, -15) != Z_OK) return false;
        bz.next_in = comp.data();
        bz.avail_in = comp_len;
        bz.next_out = r.ubuf.data();
        bz.avail_out = isize;
        int ret = inflate(&bz, Z_FINISH);
        inflateEnd(&bz);
        if (ret != Z_STREAM_END) return false;
    }
    r.block_coffset = coffset;
    r.next_coffset = coffset + bsize;
    r.upos = 0;
    return true;
}

// Advance to the next chunk of uncompressed data (any mode).
static bool bgzf_advance(BgzfReader& r) {
    if (r.at_eof) return false;
    if (r.mode == 1) {
        // skip empty blocks (BGZF EOF marker)
        int64_t off = r.next_coffset;
        while (bgzf_load_block(r, off)) {
            if (!r.ubuf.empty()) return true;
            off = r.next_coffset;
        }
        r.at_eof = true;
        return false;
    }
    if (r.mode == 2) {
        r.ubuf.resize(1 << 20);
        r.upos = 0;
        size_t produced = 0;
        while (produced == 0) {
            if (r.zs.avail_in == 0) {
                r.gz_in.resize(1 << 20);
                size_t got = fread(r.gz_in.data(), 1, r.gz_in.size(), r.fh);
                if (got == 0) { r.at_eof = true; return false; }
                r.zs.next_in = r.gz_in.data();
                r.zs.avail_in = got;
            }
            r.zs.next_out = r.ubuf.data();
            r.zs.avail_out = r.ubuf.size();
            int ret = inflate(&r.zs, Z_NO_FLUSH);
            produced = r.ubuf.size() - r.zs.avail_out;
            if (ret == Z_STREAM_END) {
                // concatenated members
                if (inflateReset2(&r.zs, 15 + 32) != Z_OK && produced == 0) {
                    r.at_eof = true;
                    return false;
                }
            } else if (ret != Z_OK) {
                r.at_eof = true;
                return produced > 0;
            }
        }
        r.ubuf.resize(produced);
        return true;
    }
    // plain file
    r.ubuf.resize(1 << 20);
    r.upos = 0;
    size_t got = fread(r.ubuf.data(), 1, r.ubuf.size(), r.fh);
    if (got == 0) { r.at_eof = true; return false; }
    r.ubuf.resize(got);
    return true;
}

static bool bgzf_open_reader(BgzfReader& r, const char* path) {
    r.fh = fopen(path, "rb");
    if (!r.fh) return false;
    uint8_t hdr[18] = {0};
    size_t got = fread(hdr, 1, 18, r.fh);
    fseek(r.fh, 0, SEEK_SET);
    if (got >= 18 && hdr[0] == 0x1f && hdr[1] == 0x8b && (hdr[3] & 4) &&
        hdr[12] == 'B' && hdr[13] == 'C') {
        r.mode = 1;
        r.next_coffset = 0;
        return bgzf_advance(r);
    }
    if (got >= 2 && hdr[0] == 0x1f && hdr[1] == 0x8b) {
        r.mode = 2;
        memset(&r.zs, 0, sizeof(r.zs));
        if (inflateInit2(&r.zs, 15 + 32) != Z_OK) return false;
        r.zs_live = true;
        return bgzf_advance(r);
    }
    r.mode = 0;
    return bgzf_advance(r);
}

static inline uint64_t bgzf_vtell(const BgzfReader& r) {
    // At a block boundary upos == ubuf.size() (possibly 65536, which would
    // wrap the 16-bit within-block field); report the start of the next
    // block, matching htslib's virtual-offset convention.
    if (r.mode == 1 && r.upos >= r.ubuf.size())
        return (uint64_t)r.next_coffset << 16;
    return ((uint64_t)r.block_coffset << 16) | (uint64_t)(r.upos & 0xffff);
}

static bool bgzf_seek_virtual(BgzfReader& r, uint64_t voff) {
    if (r.mode != 1) return false;
    r.at_eof = false;
    if (!bgzf_load_block(r, (int64_t)(voff >> 16))) return false;
    r.upos = voff & 0xffff;
    return r.upos <= r.ubuf.size();
}

// Read exactly n bytes (spanning blocks); returns bytes read.
static int64_t bgzf_read(BgzfReader& r, uint8_t* dst, int64_t n) {
    int64_t done = 0;
    while (done < n) {
        if (r.upos >= r.ubuf.size()) {
            if (!bgzf_advance(r)) break;
        }
        int64_t take = std::min<int64_t>(n - done, r.ubuf.size() - r.upos);
        memcpy(dst + done, r.ubuf.data() + r.upos, take);
        r.upos += take;
        done += take;
    }
    return done;
}

static bool bgzf_getline(BgzfReader& r, std::string& out) {
    out.clear();
    for (;;) {
        if (r.upos >= r.ubuf.size()) {
            if (!bgzf_advance(r)) return !out.empty();
        }
        const uint8_t* base = r.ubuf.data() + r.upos;
        size_t avail = r.ubuf.size() - r.upos;
        const uint8_t* nl = (const uint8_t*)memchr(base, '\n', avail);
        if (nl) {
            out.append((const char*)base, nl - base);
            r.upos += (nl - base) + 1;
            return true;
        }
        out.append((const char*)base, avail);
        r.upos += avail;
    }
}

// ---------------------------------------------------------------------------
// BAI / TBI / CSI index parsing + region query (binning scheme per the
// SAM/tabix specs; the reference relies on htslib's implementation)
// ---------------------------------------------------------------------------

struct QChunk { uint64_t beg, end; };
struct QBin { uint64_t loff = 0; std::vector<QChunk> chunks; };
struct QRef {
    std::unordered_map<uint32_t, QBin> bins;
    std::vector<uint64_t> lin;       // 16kb linear index (BAI/TBI)
};
struct QIndex {
    bool ok = false;
    bool csi = false;
    int min_shift = 14, depth = 5;
    // tabix config (TBI, or CSI aux when indexing a VCF)
    int format = 0, col_seq = 1, col_beg = 2, col_end = 0;
    int meta = '#', skip = 0;
    std::vector<std::string> names;
    std::vector<QRef> refs;
};

struct ByteCursor {
    const uint8_t* p;
    const uint8_t* end;
    bool ok = true;
    template <typename T> T get() {
        T v{};
        if (p + sizeof(T) > end) { ok = false; return v; }
        memcpy(&v, p, sizeof(T));
        p += sizeof(T);
        return v;
    }
    bool skip(size_t n) {
        if (p + n > end) { ok = false; return false; }
        p += n;
        return true;
    }
};

static void parse_names_blob(const char* p, int32_t l_nm,
                             std::vector<std::string>& names) {
    const char* q = p;
    const char* stop = p + l_nm;
    while (q < stop) {
        size_t len = strnlen(q, stop - q);
        names.emplace_back(q, len);
        q += len + 1;
    }
}

static bool parse_binning_refs(ByteCursor& c, QIndex& ix, int n_ref,
                               bool with_loff, bool with_linear) {
    ix.refs.resize(n_ref);
    for (int rid = 0; rid < n_ref && c.ok; rid++) {
        int32_t n_bin = c.get<int32_t>();
        for (int b = 0; b < n_bin && c.ok; b++) {
            uint32_t bin = c.get<uint32_t>();
            QBin& qb = ix.refs[rid].bins[bin];
            if (with_loff) qb.loff = c.get<uint64_t>();
            int32_t n_chunk = c.get<int32_t>();
            for (int k = 0; k < n_chunk && c.ok; k++) {
                QChunk ch;
                ch.beg = c.get<uint64_t>();
                ch.end = c.get<uint64_t>();
                qb.chunks.push_back(ch);
            }
        }
        if (with_linear) {
            int32_t n_intv = c.get<int32_t>();
            ix.refs[rid].lin.resize(std::max(n_intv, 0));
            for (int i = 0; i < n_intv && c.ok; i++)
                ix.refs[rid].lin[i] = c.get<uint64_t>();
        }
    }
    return c.ok;
}

static bool parse_index_buffer(const uint8_t* p, size_t n, QIndex& ix) {
    if (n < 4) return false;
    ByteCursor c{p, p + n};
    if (memcmp(p, "BAI\x01", 4) == 0) {
        c.skip(4);
        int32_t n_ref = c.get<int32_t>();
        if (!parse_binning_refs(c, ix, n_ref, false, true)) return false;
        ix.min_shift = 14;
        ix.depth = 5;
        ix.ok = true;
        return true;
    }
    if (memcmp(p, "TBI\x01", 4) == 0) {
        c.skip(4);
        int32_t n_ref = c.get<int32_t>();
        ix.format = c.get<int32_t>();
        ix.col_seq = c.get<int32_t>();
        ix.col_beg = c.get<int32_t>();
        ix.col_end = c.get<int32_t>();
        ix.meta = c.get<int32_t>();
        ix.skip = c.get<int32_t>();
        int32_t l_nm = c.get<int32_t>();
        if (!c.ok || c.p + l_nm > c.end) return false;
        parse_names_blob((const char*)c.p, l_nm, ix.names);
        c.skip(l_nm);
        if (!parse_binning_refs(c, ix, n_ref, false, true)) return false;
        ix.min_shift = 14;
        ix.depth = 5;
        ix.ok = true;
        return true;
    }
    if (memcmp(p, "CSI\x01", 4) == 0) {
        c.skip(4);
        ix.csi = true;
        ix.min_shift = c.get<int32_t>();
        ix.depth = c.get<int32_t>();
        int32_t l_aux = c.get<int32_t>();
        if (l_aux >= 28 && c.ok && c.p + l_aux <= c.end) {
            ByteCursor a{c.p, c.p + l_aux};
            ix.format = a.get<int32_t>();
            ix.col_seq = a.get<int32_t>();
            ix.col_beg = a.get<int32_t>();
            ix.col_end = a.get<int32_t>();
            ix.meta = a.get<int32_t>();
            ix.skip = a.get<int32_t>();
            int32_t l_nm = a.get<int32_t>();
            if (a.ok && a.p + l_nm <= a.end)
                parse_names_blob((const char*)a.p, l_nm, ix.names);
        }
        c.skip(l_aux);
        int32_t n_ref = c.get<int32_t>();
        if (!parse_binning_refs(c, ix, n_ref, true, false)) return false;
        ix.ok = true;
        return true;
    }
    return false;
}

static bool load_index_file(const std::string& path, QIndex& ix) {
    void* bh = qio_read_gzip(path.c_str());   // indexes are small files
    if (!bh) return false;
    QioBuffer* buf = (QioBuffer*)bh;
    bool ok = parse_index_buffer(buf->data.data(), buf->data.size(), ix);
    qio_buffer_free(bh);
    return ok;
}

static bool load_index_for(const char* data_path, bool bam, QIndex& ix) {
    std::string base(data_path);
    const char* exts_bam[] = {".bai", ".csi"};
    const char* exts_vcf[] = {".tbi", ".csi"};
    const char** exts = bam ? exts_bam : exts_vcf;
    for (int i = 0; i < 2; i++) {
        if (load_index_file(base + exts[i], ix)) return true;
        ix = QIndex();
    }
    return false;
}

static void reg2bins(int64_t beg, int64_t end, int min_shift, int depth,
                     std::vector<uint32_t>& out) {
    if (beg >= end) return;
    --end;
    int l = 0;
    int64_t t = 0;
    int s = min_shift + depth * 3;
    for (; l <= depth; s -= 3, t += 1LL << (l * 3), ++l) {
        int64_t b = t + (beg >> s), e = t + (end >> s);
        for (int64_t i = b; i <= e; ++i) out.push_back((uint32_t)i);
    }
}

// Chunks of the file overlapping [beg, end) (0-based), sorted + merged.
static std::vector<QChunk> index_query(const QIndex& ix, int tid,
                                       int64_t beg, int64_t end) {
    std::vector<QChunk> out;
    if (tid < 0 || tid >= (int)ix.refs.size()) return out;
    const QRef& rf = ix.refs[tid];
    uint64_t min_off = 0;
    if (!ix.csi) {
        if (!rf.lin.empty()) {
            size_t w = std::min((size_t)(beg >> 14), rf.lin.size() - 1);
            min_off = rf.lin[w];
        }
    } else {
        // CSI: loffset of the deepest bin containing beg, walking up;
        // offset of the deepest level = (8^depth - 1)/7
        int64_t t_leaf = ((1LL << (ix.depth * 3)) - 1) / 7;
        uint32_t b = (uint32_t)(t_leaf + (beg >> ix.min_shift));
        for (;;) {
            auto it = rf.bins.find(b);
            if (it != rf.bins.end()) { min_off = it->second.loff; break; }
            if (b == 0) break;
            b = (b - 1) >> 3;
        }
    }
    std::vector<uint32_t> bins;
    reg2bins(beg, end, ix.min_shift, ix.depth, bins);
    for (uint32_t b : bins) {
        auto it = rf.bins.find(b);
        if (it == rf.bins.end()) continue;
        for (const QChunk& ch : it->second.chunks) {
            if (ch.end <= min_off) continue;
            out.push_back({std::max(ch.beg, min_off), ch.end});
        }
    }
    std::sort(out.begin(), out.end(),
              [](const QChunk& a, const QChunk& b) { return a.beg < b.beg; });
    std::vector<QChunk> merged;
    for (const QChunk& ch : out) {
        if (!merged.empty() && ch.beg <= merged.back().end)
            merged.back().end = std::max(merged.back().end, ch.end);
        else
            merged.push_back(ch);
    }
    return merged;
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// Reference-panel VCF ingestion -> packed haplotype words
//
// Streaming (block-at-a-time BGZF) with tabix/CSI region seek; genotypes are
// bit-packed as they are parsed (1 bit/haplotype), so a chromosome-scale
// panel is never inflated to a [K, nSNPs] byte matrix on host. Equivalent of
// STITCH::Rcpp_get_hap_info_from_vcf + the streaming rare/common split at
// QUILT/R/quilt-prepare-reference.R:228-262.
// ---------------------------------------------------------------------------

struct QioPanel {
    std::vector<int64_t> pos;
    std::vector<char> ref;
    std::vector<char> alt;
    std::vector<std::string> samples;
    std::vector<uint8_t> gtbits;   // [nSNPs, (K+7)/8] row-major; bit = alt
    std::vector<int32_t> alt_cnt;  // alt-allele count per SNP
    int n_haps = 0;
    int n_skipped = 0;
    int used_index = 0;
};

static bool parse_gt_fields(const char* s, const char* end,
                            std::vector<uint8_t>& out) {
    out.clear();
    const char* p = s;
    while (p < end) {
        // one genotype field; first subfield before ':' is GT
        char a1 = *p;
        if (p + 2 >= end) return false;
        char sep = p[1];
        char a2 = p[2];
        if ((sep == '|' || sep == '/') &&
            (a1 == '0' || a1 == '1') && (a2 == '0' || a2 == '1')) {
            out.push_back(a1 - '0');
            out.push_back(a2 - '0');
            p += 3;
            // skip to next tab
            while (p < end && *p != '\t') p++;
            p++;
        } else {
            return false;
        }
    }
    return true;
}

// Parse header line (collect sample names from the #CHROM line).
static void panel_header_line(QioPanel* panel, const std::string& line) {
    if (line.size() < 2 || line[1] == '#') return;
    const char* q = line.data();
    const char* nl = q + line.size();
    int col = 0;
    while (q < nl) {
        const char* t = (const char*)memchr(q, '\t', nl - q);
        if (!t || t > nl) t = nl;
        if (col >= 9) panel->samples.emplace_back(q, t - q);
        q = t + 1;
        col++;
    }
}

// Consume one data line. Sets *past_end when the line is on the wanted
// chromosome but beyond region_end (sorted VCF -> caller may stop).
static void panel_data_line(QioPanel* panel, const std::string& line,
                            const std::string& want_chrom,
                            int64_t region_start, int64_t region_end,
                            int64_t& last_pos, std::vector<uint8_t>& tmp,
                            bool* past_end) {
    const char* p = line.data();
    const char* nl = p + line.size();
    if (p == nl || p[0] == '#') return;
    // data line: CHROM POS ID REF ALT QUAL FILTER INFO FORMAT GTs...
    const char* f[9];
    const char* q = p;
    bool ok = true;
    for (int i = 0; i < 9; i++) {
        f[i] = q;
        const char* t = (const char*)memchr(q, '\t', nl - q);
        if (!t || t >= nl) { ok = (i == 8); q = nl + 1; break; }
        q = t + 1;
    }
    if (!ok) return;
    size_t clen = strchr(f[0], '\t') - f[0];
    bool chrom_match =
        want_chrom.empty() ||
        (clen == want_chrom.size() &&
         strncmp(f[0], want_chrom.c_str(), clen) == 0);
    if (!chrom_match) return;
    int64_t pos = strtoll(f[1], nullptr, 10);
    if (region_end >= 0 && pos > region_end) {
        if (!want_chrom.empty()) *past_end = true;
        return;
    }
    if (region_start >= 0 && pos < region_start) return;
    char ref = f[3][0];
    char alt = f[4][0];
    bool bi = (f[3][1] == '\t') && (f[4][1] == '\t') &&
              strchr("ACGT", ref) && strchr("ACGT", alt);
    if (!bi || pos == last_pos) {
        panel->n_skipped++;
        return;
    }
    if (!parse_gt_fields(q, nl, tmp)) {
        panel->n_skipped++;
        return;
    }
    if (panel->n_haps == 0) panel->n_haps = tmp.size();
    if ((int)tmp.size() != panel->n_haps) {
        panel->n_skipped++;
        return;
    }
    last_pos = pos;
    panel->pos.push_back(pos);
    panel->ref.push_back(ref);
    panel->alt.push_back(alt);
    size_t stride = (panel->n_haps + 7) / 8;
    size_t base = panel->gtbits.size();
    panel->gtbits.resize(base + stride, 0);
    int32_t cnt = 0;
    for (int k = 0; k < panel->n_haps; k++) {
        if (tmp[k]) {
            panel->gtbits[base + (k >> 3)] |= (uint8_t)(1u << (k & 7));
            cnt++;
        }
    }
    panel->alt_cnt.push_back(cnt);
}

void* qio_vcf_panel(const char* path, const char* chrom,
                    int64_t region_start, int64_t region_end) {
    BgzfReader r;
    if (!bgzf_open_reader(r, path)) return nullptr;
    auto* panel = new QioPanel();
    std::string want_chrom = chrom ? chrom : "";
    std::string line;
    std::vector<uint8_t> tmp;
    int64_t last_pos = -1;
    bool past_end = false;
    // header; keep the first data line pending (getline overshoots by one)
    bool have_pending = false;
    while (bgzf_getline(r, line)) {
        if (!line.empty() && line[0] == '#') {
            panel_header_line(panel, line);
        } else {
            have_pending = true;
            break;
        }
    }
    // indexed region query (tabix .tbi / .csi alongside the VCF)
    QIndex ix;
    if (r.mode == 1 && !want_chrom.empty() && region_start >= 0 &&
        region_end >= 0 && load_index_for(path, false, ix)) {
        int tid = -1;
        for (size_t i = 0; i < ix.names.size(); i++)
            if (ix.names[i] == want_chrom) { tid = (int)i; break; }
        if (tid >= 0) {
            panel->used_index = 1;
            auto chunks = index_query(ix, tid, region_start - 1, region_end);
            for (const QChunk& ch : chunks) {
                if (past_end) break;
                if (!bgzf_seek_virtual(r, ch.beg)) break;
                while (bgzf_vtell(r) < ch.end && bgzf_getline(r, line)) {
                    panel_data_line(panel, line, want_chrom, region_start,
                                    region_end, last_pos, tmp, &past_end);
                    if (past_end) break;
                }
            }
            return panel;
        }
    }
    // sequential streaming scan
    if (have_pending)
        panel_data_line(panel, line, want_chrom, region_start, region_end,
                        last_pos, tmp, &past_end);
    while (!past_end && bgzf_getline(r, line))
        panel_data_line(panel, line, want_chrom, region_start, region_end,
                        last_pos, tmp, &past_end);
    return panel;
}

int qio_panel_n_snps(void* h) { return ((QioPanel*)h)->pos.size(); }
int qio_panel_n_haps(void* h) { return ((QioPanel*)h)->n_haps; }
int qio_panel_n_skipped(void* h) { return ((QioPanel*)h)->n_skipped; }
int qio_panel_n_samples(void* h) { return ((QioPanel*)h)->samples.size(); }
int qio_panel_used_index(void* h) { return ((QioPanel*)h)->used_index; }

void qio_panel_sites(void* h, int64_t* pos, char* ref, char* alt) {
    QioPanel* panel = (QioPanel*)h;
    int n_snps = panel->pos.size();
    for (int s = 0; s < n_snps; s++) {
        pos[s] = panel->pos[s];
        ref[s] = panel->ref[s];
        alt[s] = panel->alt[s];
    }
}

// Alt-allele count per SNP; af = alt_cnt / n_haps computed by the caller.
void qio_panel_alt_counts(void* h, int32_t* out) {
    QioPanel* panel = (QioPanel*)h;
    memcpy(out, panel->alt_cnt.data(),
           panel->alt_cnt.size() * sizeof(int32_t));
}

// Pack kept SNPs (keep==nullptr -> all) to [K, nGridsKept] uint32 words.
void qio_panel_pack(void* h, const uint8_t* keep, uint32_t* rhb_t) {
    QioPanel* panel = (QioPanel*)h;
    int n_snps = panel->pos.size();
    int K = panel->n_haps;
    size_t stride = (K + 7) / 8;
    int n_kept = 0;
    for (int s = 0; s < n_snps; s++)
        if (!keep || keep[s]) n_kept++;
    int n_grids = (n_kept + 31) / 32;
    memset(rhb_t, 0, (size_t)K * n_grids * sizeof(uint32_t));
    int ci = 0;
    for (int s = 0; s < n_snps; s++) {
        if (keep && !keep[s]) continue;
        const uint8_t* bits = &panel->gtbits[(size_t)s * stride];
        int g = ci >> 5;
        uint32_t b = 1u << (ci & 31);
        for (int k = 0; k < K; k++)
            if (bits[k >> 3] & (1u << (k & 7)))
                rhb_t[(size_t)k * n_grids + g] |= b;
        ci++;
    }
}

void qio_panel_fill(void* h, int64_t* pos, char* ref, char* alt,
                    uint32_t* rhb_t /* [K, nGrids] row-major */) {
    qio_panel_sites(h, pos, ref, alt);
    qio_panel_pack(h, nullptr, rhb_t);
}

// Rare-carrier extraction for the two-stage rare/common path: for each SNP
// with is_common[s]==0, in order, append the haplotype indices carrying the
// alt allele. Total length = sum(alt_cnt[!is_common]); the caller derives
// per-SNP offsets from alt counts.
void qio_panel_rare_carriers(void* h, const uint8_t* is_common,
                             int32_t* flat) {
    QioPanel* panel = (QioPanel*)h;
    int n_snps = panel->pos.size();
    int K = panel->n_haps;
    size_t stride = (K + 7) / 8;
    int64_t w = 0;
    for (int s = 0; s < n_snps; s++) {
        if (is_common[s]) continue;
        const uint8_t* bits = &panel->gtbits[(size_t)s * stride];
        for (int k = 0; k < K; k++)
            if (bits[k >> 3] & (1u << (k & 7))) flat[w++] = k;
    }
}

void qio_panel_sample_name(void* h, int i, char* out, int cap) {
    QioPanel* panel = (QioPanel*)h;
    snprintf(out, cap, "%s", panel->samples[i].c_str());
}

void qio_panel_free(void* h) { delete (QioPanel*)h; }

// ---------------------------------------------------------------------------
// BAM read extraction -> (snp index, signed bq) with mate / BX-tag merging.
//
// Streaming: records parse block-at-a-time from the BGZF reader; with a
// .bai/.csi index and a region, only the overlapping chunks are touched
// (the reference gets this via htslib region iterators inside STITCH's
// loadBamAndConvert; SURVEY.md 2.9, QUILT/R/quilt.R:237-238).
// ---------------------------------------------------------------------------

struct QioReads {
    std::vector<int32_t> u;        // flat SNP indices
    std::vector<int16_t> bq;       // flat signed quals
    std::vector<int64_t> offsets;  // per read, length n_reads+1
    int n_records = 0;
    int used_index = 0;
};

static const char SEQ_DECODE[17] = "=ACMGRSVTWYHKDBN";

namespace {

// Read one BAM record (block_size prefix + body); 1 = ok, 0 = EOF, -1 = bad.
static int bam_next_record(BgzfReader& r, std::vector<uint8_t>& rec) {
    uint8_t szb[4];
    int64_t got = bgzf_read(r, szb, 4);
    if (got == 0) return 0;
    if (got != 4) return -1;
    int32_t bs;
    memcpy(&bs, szb, 4);
    if (bs < 32 || bs > (64 << 20)) return -1;
    rec.resize(bs);
    if (bgzf_read(r, rec.data(), bs) != bs) return -1;
    return 1;
}

// Parse the BAM header from a stream positioned at the magic; find chrom.
static bool bam_read_header(BgzfReader& r, const char* chrom, int* tid_out) {
    uint8_t m[8];
    if (bgzf_read(r, m, 8) != 8 || memcmp(m, "BAM\x01", 4) != 0) return false;
    int32_t l_text;
    memcpy(&l_text, m + 4, 4);
    std::vector<uint8_t> scratch(l_text);
    if (bgzf_read(r, scratch.data(), l_text) != l_text) return false;
    int32_t n_ref;
    if (bgzf_read(r, (uint8_t*)&n_ref, 4) != 4) return false;
    *tid_out = -1;
    size_t want_len = strlen(chrom);
    for (int i = 0; i < n_ref; i++) {
        int32_t l_name;
        if (bgzf_read(r, (uint8_t*)&l_name, 4) != 4) return false;
        scratch.resize(l_name + 4);
        if (bgzf_read(r, scratch.data(), l_name + 4) != l_name + 4)
            return false;
        if ((size_t)(l_name - 1) == want_len &&
            strncmp((const char*)scratch.data(), chrom, want_len) == 0)
            *tid_out = i;
    }
    return true;
}

// Scan aux fields for a BX:Z tag (10x linked-read barcode).
static bool bam_find_bx(const uint8_t* aux, const uint8_t* end,
                        std::string& bx_out) {
    while (aux + 3 <= end) {
        char t0 = (char)aux[0], t1 = (char)aux[1], ty = (char)aux[2];
        aux += 3;
        size_t sz;
        switch (ty) {
            case 'A': case 'c': case 'C': sz = 1; break;
            case 's': case 'S': sz = 2; break;
            case 'i': case 'I': case 'f': sz = 4; break;
            case 'Z': case 'H': {
                const uint8_t* z =
                    (const uint8_t*)memchr(aux, 0, end - aux);
                if (!z) return false;
                if (t0 == 'B' && t1 == 'X') {
                    bx_out.assign((const char*)aux, z - aux);
                    return true;
                }
                aux = z + 1;
                continue;
            }
            case 'B': {
                if (aux + 5 > end) return false;
                char et = (char)aux[0];
                uint32_t n;
                memcpy(&n, aux + 1, 4);
                size_t es = (et == 'c' || et == 'C') ? 1
                          : (et == 's' || et == 'S') ? 2 : 4;
                sz = 5 + (size_t)n * es;
                break;
            }
            default:
                return false;
        }
        aux += sz;
    }
    return false;
}

struct BamAccum {
    // insertion-ordered groups (matches the Python reader for deterministic
    // downsampling downstream)
    std::unordered_map<std::string, size_t> group;
    std::vector<std::vector<std::pair<int32_t, int16_t>>> acc;
    std::vector<int64_t> gpos;   // first pos0 per group (BX distance split)
};

static void bam_process_record(
    const uint8_t* rec, int32_t block_size, int target_tid,
    const int64_t* snp_pos, const uint8_t* ref_code, const uint8_t* alt_code,
    int n_snps, int bq_filter, int isize_limit,
    bool use_bx, int bx_limit, bool soft_clip, BamAccum& A) {
    int32_t refID, pos0;
    memcpy(&refID, rec, 4);
    memcpy(&pos0, rec + 4, 4);
    uint8_t l_read_name = rec[8];
    uint8_t mapq = rec[9];
    uint16_t n_cigar;
    memcpy(&n_cigar, rec + 12, 2);
    uint16_t flag;
    memcpy(&flag, rec + 14, 2);
    int32_t l_seq, tlen;
    memcpy(&l_seq, rec + 16, 4);
    memcpy(&tlen, rec + 28, 4);
    const uint32_t BAD_FLAGS = 0x4 | 0x100 | 0x200 | 0x400 | 0x800;
    if (refID != target_tid || (flag & BAD_FLAGS)) return;
    if (isize_limit > 0 && tlen != 0 &&
        (tlen > isize_limit || -tlen > isize_limit))
        return;
    const char* qname = (const char*)rec + 32;
    const uint32_t* cigar = (const uint32_t*)(rec + 32 + l_read_name);
    const uint8_t* seq = rec + 32 + l_read_name + 4 * n_cigar;
    const uint8_t* qual = seq + (l_seq + 1) / 2;
    const uint8_t* aux = qual + l_seq;
    const uint8_t* rec_end = rec + block_size;
    int64_t rpos = pos0;
    int qpos = 0;
    // soft-clip handling mirrors io/bam.py: a leading S of length L aligns
    // to [pos0-L, pos0); every S op is then treated as M
    if (soft_clip && n_cigar > 0 && (cigar[0] & 0xF) == 4)
        rpos -= cigar[0] >> 4;
    std::vector<std::pair<int32_t, int16_t>> bases;
    for (int ci = 0; ci < n_cigar; ci++) {
        uint32_t c = cigar[ci];
        int op = c & 0xF;
        int ln = c >> 4;
        if (soft_clip && op == 4) op = 0;
        // MIDNSHP=X -> 0..8
        if (op == 0 || op == 7 || op == 8) {  // M, =, X
            // binary search SNPs in [rpos+1, rpos+ln] (1-based)
            const int64_t* lo =
                std::lower_bound(snp_pos, snp_pos + n_snps, rpos + 1);
            const int64_t* hi =
                std::upper_bound(snp_pos, snp_pos + n_snps, rpos + ln);
            for (const int64_t* sp = lo; sp < hi; sp++) {
                int si = sp - snp_pos;
                int off = (int)(*sp - 1 - rpos);
                int qi = qpos + off;
                if (qi < 0 || qi >= l_seq) continue;
                uint8_t nib = seq[qi >> 1];
                uint8_t base = (qi & 1) ? (nib & 0xF) : (nib >> 4);
                int bqv = qual[qi] < mapq ? qual[qi] : mapq;
                if (bqv < bq_filter) continue;
                if (base == alt_code[si])
                    bases.emplace_back(si, (int16_t)bqv);
                else if (base == ref_code[si])
                    bases.emplace_back(si, (int16_t)(-bqv));
            }
            rpos += ln;
            qpos += ln;
        } else if (op == 2 || op == 3) {  // D, N
            rpos += ln;
        } else if (op == 1 || op == 4) {  // I, S
            qpos += ln;
        }
    }
    if (bases.empty()) return;
    std::string bx;
    bool has_bx = use_bx && bam_find_bx(aux, rec_end, bx);
    std::string key = has_bx ? bx : std::string(qname);
    auto it = A.group.find(key);
    if (it == A.group.end()) {
        A.group.emplace(key, A.acc.size());
        A.acc.push_back(std::move(bases));
        A.gpos.push_back(pos0);
    } else if (has_bx && bx_limit > 0 &&
               (pos0 - A.gpos[it->second] > bx_limit ||
                A.gpos[it->second] - pos0 > bx_limit)) {
        // distant linked-read fragment: its own group (io/bam.py semantics)
        std::string key2 = key + "#" + std::to_string(pos0);
        auto it2 = A.group.find(key2);
        if (it2 == A.group.end()) {
            A.group.emplace(key2, A.acc.size());
            A.acc.push_back(std::move(bases));
            A.gpos.push_back(pos0);
        } else {
            A.acc[it2->second] = std::move(bases);
            A.gpos[it2->second] = pos0;
        }
    } else {
        auto& v = A.acc[it->second];
        v.insert(v.end(), bases.begin(), bases.end());
    }
}

}  // namespace

void* qio_bam_extract(const char* path, const char* chrom,
                      int64_t region_start, int64_t region_end,
                      const int64_t* snp_pos, const uint8_t* ref_code,
                      const uint8_t* alt_code, int n_snps,
                      int bq_filter, int isize_limit,
                      int use_bx_tag, int bx_tag_limit,
                      int use_soft_clipped) {
    BgzfReader r;
    if (!bgzf_open_reader(r, path)) return nullptr;
    int target_tid = -1;
    if (!bam_read_header(r, chrom, &target_tid)) return nullptr;
    auto* reads = new QioReads();
    BamAccum A;
    std::vector<uint8_t> rec;
    bool did_index = false;
    QIndex ix;
    if (r.mode == 1 && target_tid >= 0 && region_start >= 0 &&
        region_end >= 0 && load_index_for(path, true, ix)) {
        did_index = true;
        reads->used_index = 1;
        auto chunks = index_query(ix, target_tid, region_start - 1,
                                  region_end);
        for (const QChunk& ch : chunks) {
            if (!bgzf_seek_virtual(r, ch.beg)) break;
            while (bgzf_vtell(r) < ch.end) {
                int st = bam_next_record(r, rec);
                if (st <= 0) break;
                reads->n_records++;
                bam_process_record(rec.data(), rec.size(), target_tid,
                                   snp_pos, ref_code, alt_code, n_snps,
                                   bq_filter, isize_limit, use_bx_tag != 0,
                                   bx_tag_limit, use_soft_clipped != 0, A);
            }
        }
    }
    if (!did_index) {
        for (;;) {
            int st = bam_next_record(r, rec);
            if (st <= 0) break;
            reads->n_records++;
            bam_process_record(rec.data(), rec.size(), target_tid, snp_pos,
                               ref_code, alt_code, n_snps, bq_filter,
                               isize_limit, use_bx_tag != 0, bx_tag_limit,
                               use_soft_clipped != 0, A);
        }
    }
    reads->offsets.push_back(0);
    for (auto& v : A.acc) {
        // stable by SNP index only (parity with io/bam.py's argsort(kind=
        // "stable"): equal-|bq| dedupe ties keep the earlier base)
        std::stable_sort(v.begin(), v.end(),
                         [](const std::pair<int32_t, int16_t>& a,
                            const std::pair<int32_t, int16_t>& b) {
                             return a.first < b.first;
                         });
        // dedupe same SNP keeping max |bq|
        std::vector<std::pair<int32_t, int16_t>> ded;
        for (auto& pr : v) {
            if (!ded.empty() && ded.back().first == pr.first) {
                if (std::abs(pr.second) > std::abs(ded.back().second))
                    ded.back() = pr;
            } else {
                ded.push_back(pr);
            }
        }
        for (auto& pr : ded) {
            reads->u.push_back(pr.first);
            reads->bq.push_back(pr.second);
        }
        reads->offsets.push_back(reads->u.size());
    }
    return reads;
}

int qio_reads_used_index(void* h) { return ((QioReads*)h)->used_index; }

int qio_reads_n(void* h) { return ((QioReads*)h)->offsets.size() - 1; }
int64_t qio_reads_n_bases(void* h) { return ((QioReads*)h)->u.size(); }
int qio_reads_n_records(void* h) { return ((QioReads*)h)->n_records; }

void qio_reads_fill(void* h, int32_t* u, int16_t* bq, int64_t* offsets) {
    QioReads* r = (QioReads*)h;
    memcpy(u, r->u.data(), r->u.size() * sizeof(int32_t));
    memcpy(bq, r->bq.data(), r->bq.size() * sizeof(int16_t));
    memcpy(offsets, r->offsets.data(), r->offsets.size() * sizeof(int64_t));
}

void qio_reads_free(void* h) { delete (QioReads*)h; }

// ---------------------------------------------------------------------------
// msPBWT index build (the hot one-time loop of panel/mspbwt.py:
// build_mspbwt_indices; reference: mspbwt Rcpp_ms_BuildIndices_Algorithm5).
// Per column of the interleaved grid subset: gather symbols in the current
// PBWT order, record them (Y) + bucket offsets (C), advance the order with
// a stable counting sort, and checkpoint the positional prefix array A
// every egs columns. Blocked subset transpose keeps every inner loop in
// cache: the full build at K=100k x 10k grids runs in seconds vs ~100 s
// for the NumPy loop on this host.
// ---------------------------------------------------------------------------

// ABI version gate: io/native.py refuses a stale committed .so whose entry
// points don't match these bindings (the library is normally rebuilt from
// this source on import when the mtime is newer).
int64_t qio_abi_version() { return 3; }

void qio_mspbwt_build(
    const uint8_t* hm, int64_t K, int64_t nGrids,
    const int32_t* grids, int64_t T, int64_t egs,
    uint8_t* Y,            // out [T, K]
    int32_t* C,            // out [T, 257]
    int32_t* A_cp,         // out [n_cp, K], checkpoints at
    const int32_t* cp_cols, int64_t n_cp,
    int32_t* occ)          // out [T, K] stable argsort of each Y column
                           // (occurrence lists per symbol bucket; may be
                           // null). rank(p, s) at column t is then
                           // searchsorted(occ[t, C[t,s]:C[t,s+1]], p) —
                           // the O(log K) occurrence-checkpoint query of
                           // the reference's Algorithm-5 index structures
                           // (mspbwt Rcpp_ms_BuildIndices_Algorithm5).
{
    (void)egs;
    // blocked gather of the grid subset, transposed: X[t][k] = hm[k][grids[t]]
    std::vector<uint8_t> X((size_t)T * K);
    const int64_t TB = 128;
    for (int64_t t0 = 0; t0 < T; t0 += TB) {
        int64_t t1 = std::min(t0 + TB, T);
        for (int64_t k = 0; k < K; ++k) {
            const uint8_t* row = hm + (size_t)k * nGrids;
            for (int64_t t = t0; t < t1; ++t)
                X[(size_t)t * K + k] = row[grids[t]];
        }
    }
    std::vector<int32_t> A(K), A2(K);
    for (int64_t k = 0; k < K; ++k) A[k] = (int32_t)k;
    int64_t cp_i = 0;
    int32_t pos[257];
    for (int64_t t = 0; t < T; ++t) {
        const uint8_t* col = &X[(size_t)t * K];
        uint8_t* y = Y + (size_t)t * K;
        int32_t* Ct = C + (size_t)t * 257;
        int32_t counts[256] = {0};
        for (int64_t k = 0; k < K; ++k) {
            uint8_t s = col[A[k]];
            y[k] = s;
            counts[s]++;
        }
        Ct[0] = 0;
        for (int s = 0; s < 256; ++s) Ct[s + 1] = Ct[s] + counts[s];
        for (int s = 0; s <= 256; ++s) pos[s] = Ct[s];
        if (occ) {
            int32_t* occ_t = occ + (size_t)t * K;
            for (int64_t k = 0; k < K; ++k) {
                int32_t p = pos[y[k]]++;
                A2[p] = A[k];
                occ_t[p] = (int32_t)k;
            }
        } else {
            for (int64_t k = 0; k < K; ++k) A2[pos[y[k]]++] = A[k];
        }
        std::swap(A, A2);
        if (cp_i < n_cp && cp_cols[cp_i] == (int32_t)t) {
            memcpy(A_cp + (size_t)cp_i * K, A.data(), K * sizeof(int32_t));
            cp_i++;
        }
    }
}

// ---------------------------------------------------------------------------
// Distinct-haplotype panel compression (STITCH::make_rhb_t_equality
// equivalent, consumed at quilt-prepare-reference.R:416-428). Per grid:
// hash-count the 32-bit words, rank distinct words by (count desc, word
// asc) — identical tie-breaking to the NumPy np.unique + stable argsort
// path — keep the top nMaxDH, write the rank column. Rank 0 marks escape
// entries; the caller derives the escape COO from hapMatcher==0 in NumPy.
// Grids are partitioned across hardware threads.
// ---------------------------------------------------------------------------

static void compress_grid_range(
    const uint32_t* rhb_t, int64_t K, int64_t nGrids, int64_t nMaxDH,
    int64_t g0, int64_t g1, uint8_t* hapMatcher, uint32_t* distinctB)
{
    // open-addressing hash: word -> slot holding (word, count, rank)
    int64_t cap = 1;
    while (cap < 2 * K) cap <<= 1;
    std::vector<uint32_t> h_word(cap), h_count(cap);
    std::vector<int32_t> h_state(cap, -1);   // generation tag per grid
    std::vector<uint8_t> h_rank(cap);
    std::vector<int64_t> slots;              // distinct slots this grid
    slots.reserve(1024);
    std::vector<uint32_t> col(K);
    for (int64_t g = g0; g < g1; ++g) {
        for (int64_t k = 0; k < K; ++k)
            col[k] = rhb_t[(size_t)k * nGrids + g];
        slots.clear();
        int32_t gen = (int32_t)g;
        for (int64_t k = 0; k < K; ++k) {
            uint32_t w = col[k];
            uint64_t hsh = (uint64_t)w * 0x9E3779B97F4A7C15ull;
            int64_t i = (int64_t)(hsh >> 32) & (cap - 1);
            while (true) {
                if (h_state[i] != gen) {
                    h_state[i] = gen;
                    h_word[i] = w;
                    h_count[i] = 1;
                    slots.push_back(i);
                    break;
                }
                if (h_word[i] == w) { h_count[i]++; break; }
                i = (i + 1) & (cap - 1);
            }
        }
        // rank distinct: count desc, word asc (== np.unique value order +
        // stable argsort by -count)
        std::sort(slots.begin(), slots.end(),
                  [&](int64_t a, int64_t b) {
                      if (h_count[a] != h_count[b])
                          return h_count[a] > h_count[b];
                      return h_word[a] < h_word[b];
                  });
        int64_t nkeep = std::min<int64_t>((int64_t)slots.size(), nMaxDH);
        for (size_t si = 0; si < slots.size(); ++si)
            h_rank[slots[si]] = (si < (size_t)nkeep) ? (uint8_t)(si + 1) : 0;
        for (int64_t d = 0; d < nkeep; ++d)
            distinctB[(size_t)d * nGrids + g] = h_word[slots[d]];
        for (int64_t k = 0; k < K; ++k) {
            uint32_t w = col[k];
            uint64_t hsh = (uint64_t)w * 0x9E3779B97F4A7C15ull;
            int64_t i = (int64_t)(hsh >> 32) & (cap - 1);
            while (h_word[i] != w || h_state[i] != gen)
                i = (i + 1) & (cap - 1);
            hapMatcher[(size_t)k * nGrids + g] = h_rank[i];
        }
    }
}

void qio_compress_panel(
    const uint32_t* rhb_t, int64_t K, int64_t nGrids, int64_t nMaxDH,
    int64_t n_threads,
    uint8_t* hapMatcher,   // out [K, nGrids], 0 = escape
    uint32_t* distinctB)   // out [nMaxDH, nGrids] (zero-initialized)
{
    if (n_threads <= 1 || nGrids < 4) {
        compress_grid_range(rhb_t, K, nGrids, nMaxDH, 0, nGrids,
                            hapMatcher, distinctB);
        return;
    }
    std::vector<std::thread> threads;
    int64_t per = (nGrids + n_threads - 1) / n_threads;
    for (int64_t ti = 0; ti < n_threads; ++ti) {
        int64_t g0 = ti * per, g1 = std::min(g0 + per, nGrids);
        if (g0 >= g1) break;
        threads.emplace_back(compress_grid_range, rhb_t, K, nGrids, nMaxDH,
                             g0, g1, hapMatcher, distinctB);
    }
    for (auto& t : threads) t.join();
}

}  // extern "C"

