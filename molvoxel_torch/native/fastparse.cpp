// Fast batch SDF (V2000) parser and wire-batch assembler for the host feed.
//
// The card voxelizes ligands far faster than a Python parser reads them, so
// parsing a whole multi-record SDF buffer happens here in one pass with no
// Python objects.  molvoxel_torch.native builds this file with g++ at first
// use and binds it with ctypes (each call releases the GIL); without a
// compiler the pure-Python parser (data/parsers.py) takes its place.
//
// C ABI:
//   sdf_scan(buf, len, &mols, &atoms, &bonds)    -> 0 on success
//   sdf_parse(buf, len, coords, symbols, atom_off, bonds, bond_off, max_mols)
//       coords:  double[total_atoms * 3]
//       symbols: char[total_atoms * 4]   (NUL-padded element symbols)
//       atom_off/bond_off: int64[max_mols + 1] prefix offsets
//       bonds:   int32[total_bonds * 3]  (i, j, order), 0-based atom indices
//   returns number of molecules parsed, or -1 on malformed input.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <vector>

namespace {

struct Cursor {
  const char* p;
  const char* end;
};

// Advance to the start of the next line; returns false at EOF.
inline bool next_line(Cursor& c, const char*& line, long& len) {
  if (c.p >= c.end) return false;
  line = c.p;
  const char* nl = static_cast<const char*>(memchr(c.p, '\n', c.end - c.p));
  if (nl == nullptr) {
    len = c.end - c.p;
    c.p = c.end;
  } else {
    len = nl - c.p;
    c.p = nl + 1;
  }
  if (len > 0 && line[len - 1] == '\r') --len;
  return true;
}

// Parse a fixed-width integer field [start, start+width) with blanks.
inline long field_int(const char* line, long linelen, long start, long width) {
  long v = 0;
  bool neg = false, seen = false;
  for (long i = start; i < start + width && i < linelen; ++i) {
    char ch = line[i];
    if (ch == ' ') continue;
    if (ch == '-') { neg = true; continue; }
    if (ch < '0' || ch > '9') break;
    v = v * 10 + (ch - '0');
    seen = true;
  }
  if (!seen) return -1;
  return neg ? -v : v;
}

// Parse a fixed-width float field (coordinates, form ####.####).  Hand-rolled
// fixed-point scan: ~5x faster than strtod and exact for the <=4-decimal
// coordinates SDF V2000 carries.
inline double field_double(const char* line, long linelen, long start, long width) {
  long i = start;
  long end = start + width;
  if (end > linelen) end = linelen;
  while (i < end && line[i] == ' ') ++i;
  bool neg = false;
  if (i < end && (line[i] == '-' || line[i] == '+')) {
    neg = line[i] == '-';
    ++i;
  }
  int64_t mantissa = 0;
  int frac_digits = 0;
  bool in_frac = false;
  for (; i < end; ++i) {
    char ch = line[i];
    if (ch >= '0' && ch <= '9') {
      mantissa = mantissa * 10 + (ch - '0');
      if (in_frac) ++frac_digits;
    } else if (ch == '.' && !in_frac) {
      in_frac = true;
    } else {
      break;
    }
  }
  static const double kPow10[] = {1.0, 10.0, 100.0, 1000.0, 10000.0, 100000.0,
                                  1000000.0, 10000000.0, 100000000.0};
  double v = frac_digits <= 8 ? static_cast<double>(mantissa) / kPow10[frac_digits]
                              : static_cast<double>(mantissa) / pow(10.0, frac_digits);
  return neg ? -v : v;
}

// Skip to the record terminator "$$$$"; cursor ends after it.
inline void skip_to_record_end(Cursor& c) {
  const char* line;
  long len;
  while (next_line(c, line, len)) {
    if (len >= 4 && line[0] == '$' && line[1] == '$' && line[2] == '$' && line[3] == '$') return;
  }
}

// Read the header of the next record; returns false at EOF / malformed.
inline bool record_counts(Cursor& c, long& natoms, long& nbonds) {
  const char* line;
  long len;
  // title, program, comment
  for (int i = 0; i < 3; ++i) {
    if (!next_line(c, line, len)) return false;
  }
  if (!next_line(c, line, len)) return false;  // counts line
  natoms = field_int(line, len, 0, 3);
  nbonds = field_int(line, len, 3, 3);
  return natoms >= 0 && nbonds >= 0;
}

}  // namespace

extern "C" {

int64_t sdf_scan(const char* buf, int64_t buflen, int64_t* n_mols, int64_t* n_atoms, int64_t* n_bonds) {
  Cursor c{buf, buf + buflen};
  int64_t mols = 0, atoms = 0, bonds = 0;
  const char* line;
  long len;
  while (c.p < c.end) {
    long na, nb;
    if (!record_counts(c, na, nb)) break;
    atoms += na;
    bonds += nb;
    ++mols;
    // skip atom + bond lines
    for (long i = 0; i < na + nb; ++i) {
      if (!next_line(c, line, len)) return -1;
    }
    skip_to_record_end(c);
  }
  *n_mols = mols;
  *n_atoms = atoms;
  *n_bonds = bonds;
  return 0;
}

int64_t sdf_parse(const char* buf, int64_t buflen, double* coords, char* symbols, int64_t* atom_off,
                  int32_t* bonds, int64_t* bond_off, int64_t max_mols) {
  Cursor c{buf, buf + buflen};
  int64_t mols = 0, atom_base = 0, bond_base = 0;
  const char* line;
  long len;
  atom_off[0] = 0;
  bond_off[0] = 0;
  while (c.p < c.end && mols < max_mols) {
    long na, nb;
    if (!record_counts(c, na, nb)) break;
    for (long i = 0; i < na; ++i) {
      if (!next_line(c, line, len)) return -1;
      double* xyz = coords + (atom_base + i) * 3;
      xyz[0] = field_double(line, len, 0, 10);
      xyz[1] = field_double(line, len, 10, 10);
      xyz[2] = field_double(line, len, 20, 10);
      char* sym = symbols + (atom_base + i) * 4;
      sym[0] = sym[1] = sym[2] = sym[3] = '\0';
      long n = 0;
      for (long j = 31; j < 34 && j < len && n < 3; ++j) {
        if (line[j] != ' ') sym[n++] = line[j];
      }
    }
    for (long i = 0; i < nb; ++i) {
      if (!next_line(c, line, len)) return -1;
      int32_t* b = bonds + (bond_base + i) * 3;
      b[0] = static_cast<int32_t>(field_int(line, len, 0, 3)) - 1;
      b[1] = static_cast<int32_t>(field_int(line, len, 3, 3)) - 1;
      b[2] = static_cast<int32_t>(field_int(line, len, 6, 3));
    }
    atom_base += na;
    bond_base += nb;
    ++mols;
    atom_off[mols] = atom_base;
    bond_off[mols] = bond_base;
    skip_to_record_end(c);
  }
  return mols;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Wire-batch assembly: FlatClouds columns -> (M, Vp, 4) int16 wire batches.
//
// Replaces the numpy superbatch assembly of the streaming path
// (data/feed.py assemble_batches + morton_presort + pack_wire) with one
// GIL-releasing pass: per molecule, center (f64-accumulated mean cast to
// f32, matching _group_centers), optionally Morton-sort atoms by 5-bit
// cell keys (matching morton_presort bit for bit), quantize centered
// coords to int16 fixed point at `scale` steps/A (round-half-even, matching
// np.rint), and write [x_q, y_q, z_q, type] rows; padding slots get
// type = -1.  Being one C call, it overlaps the stream's launch thread,
// which the numpy stages holding the GIL could not.
//
//   wire_assemble(coords f32 (TA,3), types i32 (TA,), counts i64 (M,),
//                 m, vp, scale, presort, cell_lb, cell_scale, cells,
//                 wire i16 (M*vp*4), num_atoms i32 (M,)) -> molecules written

namespace {

// bit i of a 5-bit value lands at bit 3i (data/feed.py _MORTON_PART_TABLE)
inline int32_t morton_part(int32_t v) {
  int32_t r = 0;
  for (int i = 0; i < 5; ++i) r |= ((v >> i) & 1) << (3 * i);
  return r;
}

}  // namespace

extern "C" {

int64_t wire_assemble(const float* coords, const int32_t* types, const int64_t* counts,
                      int64_t m, int64_t vp, float scale, int32_t presort,
                      float cell_lb, float cell_scale, int32_t cells,
                      int16_t* wire, int32_t* num_atoms) {
  std::vector<std::pair<int32_t, int32_t>> order;  // (key, source index)
  int64_t base = 0;
  for (int64_t mi = 0; mi < m; ++mi) {
    const int64_t n = counts[mi];
    num_atoms[mi] = static_cast<int32_t>(n);
    const float* mc = coords + base * 3;
    const int32_t* mt = types + base;
    int16_t* w = wire + mi * vp * 4;

    double sx = 0.0, sy = 0.0, sz = 0.0;
    for (int64_t i = 0; i < n; ++i) {
      sx += mc[i * 3 + 0];
      sy += mc[i * 3 + 1];
      sz += mc[i * 3 + 2];
    }
    const double inv = n > 0 ? 1.0 / static_cast<double>(n) : 0.0;
    const float cx = static_cast<float>(sx * inv);
    const float cy = static_cast<float>(sy * inv);
    const float cz = static_cast<float>(sz * inv);

    if (presort && n > 1) {
      order.clear();
      for (int64_t i = 0; i < n; ++i) {
        int32_t cell[3];
        const float ctr[3] = {cx, cy, cz};
        for (int ax = 0; ax < 3; ++ax) {
          float v = (mc[i * 3 + ax] - ctr[ax] - cell_lb) * cell_scale;
          if (v < 0.0f) v = 0.0f;
          if (v > static_cast<float>(cells)) v = static_cast<float>(cells);
          cell[ax] = static_cast<int32_t>(v);  // truncation, matches .astype(int32)
        }
        const int32_t key =
            (morton_part(cell[0]) << 2) | (morton_part(cell[1]) << 1) | morton_part(cell[2]);
        order.emplace_back(key, static_cast<int32_t>(i));
      }
      std::stable_sort(order.begin(), order.end(),
                       [](const auto& a, const auto& b) { return a.first < b.first; });
    }

    for (int64_t s = 0; s < n; ++s) {
      const int64_t i = (presort && n > 1) ? order[s].second : s;
      for (int ax = 0; ax < 3; ++ax) {
        const float ctr = ax == 0 ? cx : (ax == 1 ? cy : cz);
        float q = nearbyintf((mc[i * 3 + ax] - ctr) * scale);  // round-half-even = np.rint
        if (q > 32767.0f) q = 32767.0f;
        if (q < -32767.0f) q = -32767.0f;
        w[s * 4 + ax] = static_cast<int16_t>(q);
      }
      w[s * 4 + 3] = static_cast<int16_t>(mt[i]);
    }
    for (int64_t s = n; s < vp; ++s) {
      // padding parks at +32767 steps (>= 8 A beyond the box by wire_scale
      // construction): the kernel's plane ranges prune these slots entirely,
      // unlike box-center padding which costs zero-weight range work
      w[s * 4 + 0] = w[s * 4 + 1] = w[s * 4 + 2] = 32767;
      w[s * 4 + 3] = -1;
    }
    base += n;
  }
  return m;
}

}  // extern "C"
