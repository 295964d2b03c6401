// aztocore — native host runtime for the TPU MD engine.
//
// Plays the role of the reference's C++ host layer (file scanners
// utils.cpp:87-195, buffered stat flush cuStat.cu:40-71, text writers
// out_md.cpp) for the pieces where Python is too slow: bulk text
// formatting of trajectory/stat rows and bulk parsing of large xyz
// decks.  Exposed as a plain C ABI consumed via ctypes.
//
// Build: g++ -O3 -march=native -shared -fPIC -o _aztocore.so aztocore.cpp

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>

extern "C" {

// ---------------------------------------------------------------------
// %f-compatible fixed-6-decimal float formatting (fast path)
// ---------------------------------------------------------------------

// writes the %f rendering of v into out, returns chars written
static int fmt_f6(char* out, double v) {
    if (!std::isfinite(v)) return std::sprintf(out, "%f", v);
    char* p = out;
    if (std::signbit(v)) { *p++ = '-'; v = -v; }
    if (v >= 9.2e18) return (int)(p - out) + std::sprintf(p, "%f", v);
    // round to 6 decimals
    unsigned long long scaled = (unsigned long long)(v * 1e6 + 0.5);
    unsigned long long ip = scaled / 1000000ULL;
    unsigned long long fp = scaled % 1000000ULL;
    // integer part
    char tmp[24];
    int n = 0;
    if (ip == 0) tmp[n++] = '0';
    while (ip) { tmp[n++] = (char)('0' + ip % 10); ip /= 10; }
    while (n) *p++ = tmp[--n];
    *p++ = '.';
    // fraction, zero-padded to 6
    for (int d = 5; d >= 0; --d) {
        p[d] = (char)('0' + fp % 10);
        fp /= 10;
    }
    p += 6;
    return (int)(p - out);
}

static int fmt_int(char* out, long long v) {
    return std::sprintf(out, "%lld", v);
}

// ---------------------------------------------------------------------
// Row writer: buffered FILE* wrapper
// ---------------------------------------------------------------------

struct RowFile {
    FILE* f;
    char* buf;      // row formatting buffer
    size_t cap;
};

void* azto_open(const char* path, const char* mode) {
    FILE* f = std::fopen(path, mode);
    if (!f) return nullptr;
    RowFile* r = new RowFile();
    r->f = f;
    r->cap = 1 << 20;
    r->buf = (char*)std::malloc(r->cap);
    return r;
}

void azto_write_str(void* h, const char* s) {
    RowFile* r = (RowFile*)h;
    std::fwrite(s, 1, std::strlen(s), r->f);
}

static void ensure_cap(RowFile* r, size_t need) {
    if (need > r->cap) {
        while (r->cap < need) r->cap *= 2;
        r->buf = (char*)std::realloc(r->buf, r->cap);
    }
}

// One tab-separated row: time (f6), step (int), then `n` float values.
// Mirrors copy_stat/copy_traj's "%f\t%d" + "\t%f"*n (cuStat.cu:52-66,846-852).
void azto_write_row_f(void* h, double time, long long step,
                      const double* vals, int64_t n, int newline_first) {
    RowFile* r = (RowFile*)h;
    ensure_cap(r, 32 * (size_t)(n + 2) + 8);
    char* p = r->buf;
    if (newline_first) *p++ = '\n';
    p += fmt_f6(p, time);
    *p++ = '\t';
    p += fmt_int(p, step);
    for (int64_t i = 0; i < n; ++i) {
        *p++ = '\t';
        p += fmt_f6(p, vals[i]);
    }
    if (!newline_first) *p++ = '\n';
    std::fwrite(r->buf, 1, (size_t)(p - r->buf), r->f);
}

// Trajectory row (copy_traj layout, cuStat.cu:836-860): per atom
// x y z type ptype, with type/ptype ALSO rendered as %f like the
// reference (it stores them in the float buffer).
void azto_write_traj_row(void* h, double time, long long step,
                         const float* pos /* (n,3) */,
                         const int32_t* types, const int32_t* ptypes,
                         int64_t n) {
    RowFile* r = (RowFile*)h;
    ensure_cap(r, 32 * (size_t)(5 * n + 2) + 8);
    char* p = r->buf;
    *p++ = '\n';
    p += fmt_f6(p, time);
    *p++ = '\t';
    p += fmt_int(p, step);
    for (int64_t i = 0; i < n; ++i) {
        *p++ = '\t'; p += fmt_f6(p, pos[i * 3 + 0]);
        *p++ = '\t'; p += fmt_f6(p, pos[i * 3 + 1]);
        *p++ = '\t'; p += fmt_f6(p, pos[i * 3 + 2]);
        *p++ = '\t'; p += fmt_f6(p, (double)types[i]);
        *p++ = '\t'; p += fmt_f6(p, (double)ptypes[i]);
    }
    std::fwrite(r->buf, 1, (size_t)(p - r->buf), r->f);
}

// xyz atom block writer (out_atoms, out_md.cpp:65-87): name\tx\ty\tz rows.
// names: packed char array, 8 bytes per atom (NUL-padded).
void azto_write_xyz_rows(void* h, const char* names8,
                         const double* pos /* (n,3) */, int64_t n) {
    RowFile* r = (RowFile*)h;
    ensure_cap(r, 112 * (size_t)n + 8);
    char* p = r->buf;
    for (int64_t i = 0; i < n; ++i) {
        const char* nm = names8 + i * 8;
        for (int k = 0; k < 8 && nm[k]; ++k) *p++ = nm[k];
        *p++ = '\t'; p += fmt_f6(p, pos[i * 3 + 0]);
        *p++ = '\t'; p += fmt_f6(p, pos[i * 3 + 1]);
        *p++ = '\t'; p += fmt_f6(p, pos[i * 3 + 2]);
        *p++ = '\n';
    }
    std::fwrite(r->buf, 1, (size_t)(p - r->buf), r->f);
}

void azto_close(void* h) {
    RowFile* r = (RowFile*)h;
    std::fclose(r->f);
    std::free(r->buf);
    delete r;
}

// ---------------------------------------------------------------------
// Bulk xyz parsing (read_atoms_box, sys_init.cpp:487-588): after the
// header lines, each line is "name x y z [q]".  Fills names8 (8 bytes
// per atom), pos (n,3).  Returns number of atoms parsed, or -1.
// ---------------------------------------------------------------------

int64_t azto_parse_xyz_rows(const char* text, int64_t len, int64_t n,
                            char* names8, double* pos) {
    const char* p = text;
    const char* end = text + len;
    for (int64_t i = 0; i < n; ++i) {
        // skip whitespace/newlines
        while (p < end && (*p == ' ' || *p == '\t' || *p == '\r'
                           || *p == '\n')) ++p;
        if (p >= end) return i;
        // name (max 7 chars + NUL)
        char* nm = names8 + i * 8;
        int k = 0;
        while (p < end && *p != ' ' && *p != '\t' && *p != '\n'
               && *p != '\r') {
            if (k < 7) nm[k++] = *p;
            ++p;
        }
        while (k < 8) nm[k++] = 0;
        // three coordinates; like the reference's fscanf("%s %lf %lf
        // %lf") there are no line semantics (sys_init.cpp:534)
        for (int c = 0; c < 3; ++c) {
            char* q;
            pos[i * 3 + c] = std::strtod(p, &q);
            if (q == p) return -1;
            p = q;
        }
    }
    return n;
}

}  // extern "C"
