// Columnar record codec of the consume path.
//
// The port's copy of the record-column codec in the JAX package's native
// engine (decode_record_columns_v2 / encode_record_columns): a stored
// record slab (the varint-framed records of one batch, see
// protocol/record.py) is parsed straight into columns, and output columns
// are encoded back into a slab, with no per-record Python objects. Parsing
// and bounds checks follow the reference record for record; the columns are
// written into arrays the caller allocates (numpy), so nothing is copied
// twice:
//
//   h = fluvio_records_scan(raw, len, align, &counts)   // counts[4]
//   fluvio_records_fill(h, raw, val_flat, val_off, val_len, key_flat,
//                       key_off, key_present, off_delta, ts_delta)  // frees h
//   (or fluvio_records_scan_free(h) when the columns cannot be allocated)
//
// `align` (a power of two) places every value at an aligned offset of
// val_flat with zeroed gaps: at 4 that is the engine's ragged upload form.
// C ABI only, loaded with ctypes.

#include <cstdint>
#include <cstring>
#include <new>
#include <vector>

namespace {

// zigzag varint (fluvio-protocol varint.rs semantics)
bool read_varint(const uint8_t* buf, int64_t len, int64_t& pos, int64_t& out) {
    uint64_t result = 0;
    int shift = 0;
    while (pos < len) {
        uint8_t b = buf[pos++];
        result |= (uint64_t)(b & 0x7F) << shift;
        if (!(b & 0x80)) {
            out = (int64_t)(result >> 1) ^ -(int64_t)(result & 1);
            return true;
        }
        shift += 7;
        if (shift > 63) return false;
    }
    return false;
}

int64_t varint_size(int64_t v) {
    uint64_t u = ((uint64_t)v << 1) ^ (uint64_t)(v >> 63);
    int64_t size = 1;
    while (u >= 0x80) { u >>= 7; size++; }
    return size;
}

void write_varint(uint8_t*& p, int64_t v) {
    uint64_t u = ((uint64_t)v << 1) ^ (uint64_t)(v >> 63);
    while (u >= 0x80) { *p++ = (uint8_t)(u | 0x80); u >>= 7; }
    *p++ = (uint8_t)u;
}

struct View { int64_t voff, vlen, koff, klen, od, td; bool has_key; };

struct Scan {
    std::vector<View> views;
    int64_t align;
};

int64_t inner_size(int64_t vlen, int64_t klen, bool has_key, int64_t od, int64_t td) {
    int64_t inner = 1;  // attributes
    inner += varint_size(td);
    inner += varint_size(od);
    inner += 1;  // key tag
    if (has_key) inner += varint_size(klen) + klen;
    inner += varint_size(vlen) + vlen;
    inner += varint_size(0);  // header count
    return inner;
}

}  // namespace

extern "C" {

// Parse the slab's whole well-formed records. counts: [records, bytes
// parsed (!= len means a malformed tail), aligned value bytes, key bytes].
// Returns the scan handle fluvio_records_fill consumes, or null when out of
// memory.
void* fluvio_records_scan(const uint8_t* raw, int64_t raw_len, int64_t align,
                          int64_t* counts) {
    // the rounding below is mask-based: align must be a power of two
    if (align <= 0 || (align & (align - 1)) != 0) align = 1;
    auto* s = new (std::nothrow) Scan();
    if (!s) return nullptr;
    s->align = align;
    int64_t pos = 0, total_va = 0, total_k = 0, good = 0;
    while (pos < raw_len) {
        int64_t rec_start = pos;
        int64_t inner = 0;
        if (!read_varint(raw, raw_len, pos, inner)) { pos = rec_start; break; }
        int64_t end = pos + inner;
        if (end > raw_len || inner < 0) { pos = rec_start; break; }
        View v{};
        if (pos >= end) { pos = rec_start; break; }
        pos += 1;  // attributes
        if (!read_varint(raw, end, pos, v.td) ||
            !read_varint(raw, end, pos, v.od)) { pos = rec_start; break; }
        if (pos >= end) { pos = rec_start; break; }
        uint8_t has_key = raw[pos++];
        if (has_key) {
            int64_t klen = 0;
            if (!read_varint(raw, end, pos, klen)) { pos = rec_start; break; }
            if (klen < 0 || pos + klen > end) { pos = rec_start; break; }
            v.has_key = true;
            v.koff = pos;
            v.klen = klen;
            pos += klen;
            total_k += klen;
        }
        int64_t vlen = 0;
        if (!read_varint(raw, end, pos, vlen)) { pos = rec_start; break; }
        if (vlen < 0 || pos + vlen > end) { pos = rec_start; break; }
        v.voff = pos;
        v.vlen = vlen;
        pos = end;  // skip record headers
        good = pos;
        total_va += (vlen + align - 1) & ~(align - 1);
        s->views.push_back(v);
    }
    counts[0] = (int64_t)s->views.size();
    counts[1] = good;
    counts[2] = total_va;
    counts[3] = total_k;
    return s;
}

// Free a scan handle that fluvio_records_fill will not consume.
void fluvio_records_scan_free(void* handle) { delete static_cast<Scan*>(handle); }

// Write the scanned records' columns and free the handle. val_flat must be
// zeroed (the alignment gaps stay zero: they ride the link inside the flat);
// val_off and key_off hold count + 1 entries.
void fluvio_records_fill(void* handle, const uint8_t* raw, uint8_t* val_flat,
                         int64_t* val_off, int64_t* val_len, uint8_t* key_flat,
                         int64_t* key_off, uint8_t* key_present,
                         int64_t* off_delta, int64_t* ts_delta) {
    auto* s = static_cast<Scan*>(handle);
    const int64_t align = s->align;
    int64_t vo = 0, ko = 0, n = (int64_t)s->views.size();
    for (int64_t i = 0; i < n; i++) {
        const View& v = s->views[(size_t)i];
        val_off[i] = vo;
        val_len[i] = v.vlen;
        std::memcpy(val_flat + vo, raw + v.voff, (size_t)v.vlen);
        vo += (v.vlen + align - 1) & ~(align - 1);
        key_off[i] = ko;
        if (v.has_key) {
            std::memcpy(key_flat + ko, raw + v.koff, (size_t)v.klen);
            ko += v.klen;
        }
        key_present[i] = v.has_key ? 1 : 0;
        off_delta[i] = v.od;
        ts_delta[i] = v.td;
    }
    val_off[n] = vo;
    key_off[n] = ko;
    delete s;
}

// Encoded size of n records given as columns (exact offsets: val_off and
// key_off hold n + 1 entries).
int64_t fluvio_records_encoded_size(const int64_t* val_off, const int64_t* key_off,
                                    const uint8_t* key_present, const int64_t* off_delta,
                                    const int64_t* ts_delta, int64_t n) {
    int64_t total = 0;
    for (int64_t i = 0; i < n; i++) {
        bool has_key = key_present[i] != 0;
        int64_t inner = inner_size(val_off[i + 1] - val_off[i], key_off[i + 1] - key_off[i],
                                   has_key, off_delta[i], ts_delta[i]);
        total += varint_size(inner) + inner;
    }
    return total;
}

// Encode n records into out (fluvio_records_encoded_size bytes): attributes
// 0 and no record headers, as Record.encode writes them.
void fluvio_records_encode(const uint8_t* val_flat, const int64_t* val_off,
                           const uint8_t* key_flat, const int64_t* key_off,
                           const uint8_t* key_present, const int64_t* off_delta,
                           const int64_t* ts_delta, int64_t n, uint8_t* out) {
    uint8_t* p = out;
    for (int64_t i = 0; i < n; i++) {
        int64_t vlen = val_off[i + 1] - val_off[i];
        int64_t klen = key_off[i + 1] - key_off[i];
        bool has_key = key_present[i] != 0;
        write_varint(p, inner_size(vlen, klen, has_key, off_delta[i], ts_delta[i]));
        *p++ = 0;  // attributes
        write_varint(p, ts_delta[i]);
        write_varint(p, off_delta[i]);
        if (has_key) {
            *p++ = 1;
            write_varint(p, klen);
            std::memcpy(p, key_flat + key_off[i], (size_t)klen);
            p += klen;
        } else {
            *p++ = 0;
        }
        write_varint(p, vlen);
        std::memcpy(p, val_flat + val_off[i], (size_t)vlen);
        p += vlen;
        write_varint(p, 0);  // no record headers
    }
}

}  // extern "C"
