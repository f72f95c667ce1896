// The host stage of JPEG 2000 reading: markers, tier-2 and tier-1 of a
// codestream, as OpenJPEG 2.5.4 (the library PIL 12.1 runs) reads them,
// into every tile-component's plane of coefficients for kernels D1 and M1
// (csrc/j2k_pixels.cu). Host code only: ops/_build.py builds it with nvcc
// into a library, the CPU tests with g++ -x c++. Its Python twin is
// io/j2k.py (markers, geometry), io/j2k_t2.py (packets) and io/j2k_t1.py
// (code-blocks); ops/j2k.py says what the tables hold.
//
//   int j2k_decode(const uint8_t* cs, int64_t n, int32_t* coeffs,
//                  int64_t cap_coeffs, int32_t* tcs, int cap_tcs,
//                  int32_t* tiles, int cap_tiles, int64_t* info)
//
// reads the codestream; where the buffers are too small (a first call
// with none) it returns 1 with only info filled: [coefficients,
// tile-components, tiles, components, Xsiz, Ysiz, XOsiz, YOsiz, XTOsiz,
// YTOsiz, XTsiz, YTsiz, the byte of the codestream an error was found
// at]. It returns 0 when it has filled the buffers, else an error code
// (ops/j2k.ERRORS). j2k_components writes each component's precision,
// signedness and subsampling.

#include <algorithm>
#include <array>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <map>
#include <vector>

namespace {

enum { E_NEED = 1, E_NOT_J2K = 2, E_HT = 3, E_DAMAGED = 4,
       E_UNSUPPORTED = 5, E_NO_EOC = 6, E_SOP_EPH = 7 };
constexpr int MAX_RES = 33, TC_COLS = 8 + 4 * MAX_RES, TILE_COLS = 6;

struct Fail { int code; int64_t at; };
[[noreturn]] void fail(int code, int64_t at = 0) { throw Fail{code, at}; }

int64_t ceildiv(int64_t a, int64_t b) { return (a + b - 1) / b; }
int64_t cdp2(int64_t a, int b) { return (a + ((int64_t)1 << b) - 1) >> b; }

struct Component { int prec, sgnd, dx, dy; };

struct Coding {
  int levels = 0, cbw = 6, cbh = 6, style = 0, reversible = 1;
  std::vector<std::pair<int, int>> precincts;
  int qstyle = 0, guard = 2;
  std::vector<std::pair<int, int>> steps;
  int roishift = 0;
  std::pair<int, int> step(int band) const {
    if (qstyle == 1) {
      int e0 = steps[0].first, m0 = steps[0].second;
      return {band ? std::max(e0 - (band - 1) / 3, 0) : e0, m0};
    }
    if (band >= (int)steps.size()) fail(E_DAMAGED);
    return steps[band];
  }
};

struct Defaults {
  bool has_cod = false, has_qcd = false;
  int order = 0, layers = 1, mct = 0, sop = 0, eph = 0;
  Coding cod, qcd;
  std::map<int, Coding> coc, qcc;
  std::map<int, int> rgn;
  std::vector<std::vector<int>> pocs;
};

struct Tile {
  int index = 0, order = 0, layers = 1, mct = 0, sop = 0, eph = 0, parts = 0;
  std::vector<Coding> comps;
  std::vector<std::vector<int>> pocs;
  std::vector<uint8_t> data;
  std::vector<std::pair<int, std::vector<uint8_t>>> ppt;
};

struct Codestream {
  int64_t x0, y0, x1, y1, tx0, ty0, tdx, tdy;
  std::vector<Component> comps;
  std::vector<Tile> tiles;
  bool has_ppm = false;
  std::vector<uint8_t> ppm;
  int64_t across() const { return ceildiv(x1 - tx0, tdx); }
  int64_t down() const { return ceildiv(y1 - ty0, tdy); }
};

int u16(const uint8_t* b) { return (b[0] << 8) | b[1]; }
uint32_t u32(const uint8_t* b) {
  return ((uint32_t)b[0] << 24) | ((uint32_t)b[1] << 16) | (b[2] << 8) | b[3];
}

void spcod(const uint8_t* seg, int n, int at, Coding& c, bool precincts) {
  if (n < at + 5) fail(E_DAMAGED);
  c.levels = seg[at];
  c.cbw = seg[at + 1] + 2;
  c.cbh = seg[at + 2] + 2;
  c.style = seg[at + 3];
  c.reversible = seg[at + 4] == 1;
  if (c.levels > MAX_RES - 1) fail(E_DAMAGED);
  if (c.cbw > 10 || c.cbh > 10 || c.cbw + c.cbh > 12) fail(E_DAMAGED);
  if (seg[at + 4] > 1) fail(E_UNSUPPORTED);
  if (c.style & 0x40) fail(E_HT);
  if (c.style & 0x80) fail(E_UNSUPPORTED);
  at += 5;
  c.precincts.clear();
  if (precincts) {
    if (n < at + c.levels + 1) fail(E_DAMAGED);
    for (int r = 0; r <= c.levels; ++r) {
      int b = seg[at + r];
      if (r && ((b & 15) == 0 || (b >> 4) == 0)) fail(E_DAMAGED);
      c.precincts.push_back({b & 15, b >> 4});
    }
  } else {
    for (int r = 0; r <= c.levels; ++r) c.precincts.push_back({15, 15});
  }
}

void sqcd(const uint8_t* seg, int n, int at, Coding& c) {
  if (n < at + 1) fail(E_DAMAGED);
  c.qstyle = seg[at] & 0x1F;
  c.guard = seg[at] >> 5;
  ++at;
  c.steps.clear();
  if (c.qstyle == 0) {
    for (int i = at; i < n; ++i) c.steps.push_back({seg[i] >> 3, 0});
  } else if (c.qstyle == 1 || c.qstyle == 2) {
    int k = (n - at) / 2;
    if (c.qstyle == 1) k = std::min(k, 1);
    for (int i = 0; i < k; ++i) {
      int v = u16(seg + at + 2 * i);
      c.steps.push_back({v >> 11, v & 0x7FF});
    }
  } else {
    fail(E_DAMAGED);
  }
  if (c.steps.empty()) fail(E_DAMAGED);
}

void header_marker(int m, const uint8_t* seg, int n, Defaults& d, int ncomp,
                   bool main, Tile* tile,
                   std::vector<std::pair<int, std::vector<uint8_t>>>* ppm) {
  int room = ncomp < 257 ? 1 : 2;
  auto comp_at = [&](int at) {
    if (n < at + room) fail(E_DAMAGED);
    int c = room == 1 ? seg[at] : u16(seg + at);
    if (c >= ncomp) fail(E_DAMAGED);
    return c;
  };
  switch (m) {
    case 0xFF52: {  // COD
      if (n < 5) fail(E_DAMAGED);
      Coding c;
      spcod(seg, n, 5, c, seg[0] & 1);
      if (seg[1] > 4) fail(E_DAMAGED);
      int layers = u16(seg + 2);
      if (layers == 0) fail(E_DAMAGED);
      if (seg[4] > 1) fail(E_UNSUPPORTED);
      d.has_cod = true;
      d.order = seg[1];
      d.layers = layers;
      d.mct = seg[4];
      d.sop = (seg[0] & 2) != 0;
      d.eph = (seg[0] & 4) != 0;
      d.cod = c;
      break;
    }
    case 0xFF53: {  // COC
      int c = comp_at(0);
      Coding k;
      if (n < room + 1) fail(E_DAMAGED);
      spcod(seg, n, room + 1, k, seg[room] & 1);
      d.coc[c] = k;
      break;
    }
    case 0xFF5C: {  // QCD
      Coding k;
      sqcd(seg, n, 0, k);
      d.has_qcd = true;
      d.qcd = k;
      break;
    }
    case 0xFF5D: {  // QCC
      int c = comp_at(0);
      Coding k;
      sqcd(seg, n, room, k);
      d.qcc[c] = k;
      break;
    }
    case 0xFF5E: {  // RGN
      int c = comp_at(0);
      if (n < room + 2) fail(E_DAMAGED);
      if (seg[room] != 0) fail(E_UNSUPPORTED);
      d.rgn[c] = seg[room + 1];
      break;
    }
    case 0xFF5F: {  // POC
      int step = 5 + 2 * room;
      if (n == 0 || n % step) fail(E_DAMAGED);
      for (int at = 0; at < n; at += step) {
        int r0 = seg[at];
        int c0 = room == 1 ? seg[at + 1] : u16(seg + at + 1);
        int l1 = u16(seg + at + 1 + room);
        int r1 = seg[at + 3 + room];
        int c1 = room == 1 ? seg[at + 4 + room] : u16(seg + at + 4 + room);
        int prg = seg[at + 4 + 2 * room];
        if (prg > 4) fail(E_DAMAGED);
        d.pocs.push_back({r0, c0, l1, r1, std::min(c1, ncomp), prg});
      }
      break;
    }
    case 0xFF60:  // PPM
      if (!main || n < 1) fail(E_DAMAGED);
      ppm->push_back({seg[0], std::vector<uint8_t>(seg + 1, seg + n)});
      break;
    case 0xFF61:  // PPT
      if (main || n < 1) fail(E_DAMAGED);
      tile->ppt.push_back({seg[0], std::vector<uint8_t>(seg + 1, seg + n)});
      break;
    case 0xFF50:  // CAP
      fail(E_HT);
    case 0xFF55: case 0xFF57: case 0xFF58: case 0xFF63: case 0xFF64:
    case 0xFF59:
      break;
    default:
      fail(E_DAMAGED);
  }
}

Coding coding_for(int c, const Defaults& t, const Defaults& m) {
  Coding out;
  const Coding* cod = nullptr;
  if (t.coc.count(c)) cod = &t.coc.at(c);
  else if (t.has_cod) cod = &t.cod;
  else if (m.coc.count(c)) cod = &m.coc.at(c);
  else if (m.has_cod) cod = &m.cod;
  const Coding* q = nullptr;
  if (t.qcc.count(c)) q = &t.qcc.at(c);
  else if (t.has_qcd) q = &t.qcd;
  else if (m.qcc.count(c)) q = &m.qcc.at(c);
  else if (m.has_qcd) q = &m.qcd;
  if (!cod || !q) fail(E_DAMAGED);
  out = *cod;
  out.qstyle = q->qstyle;
  out.guard = q->guard;
  out.steps = q->steps;
  out.roishift = t.rgn.count(c) ? t.rgn.at(c) : m.rgn.count(c) ? m.rgn.at(c)
                                                                 : 0;
  return out;
}

Codestream parse(const uint8_t* cs, int64_t len) {
  if (len < 4 || u16(cs) != 0xFF4F || u16(cs + 2) != 0xFF51) fail(E_NOT_J2K);
  int64_t i = 2;
  auto segment = [&](int64_t at, int& m, const uint8_t*& seg, int& n) {
    if (at + 4 > len) fail(E_DAMAGED, at);
    m = u16(cs + at);
    if (m < 0xFF30) fail(E_DAMAGED, at);
    int l = u16(cs + at + 2);
    if (l < 2 || at + 2 + l > len) fail(E_DAMAGED, at);
    seg = cs + at + 4;
    n = l - 2;
    return at + 2 + l;
  };
  int m, n;
  const uint8_t* seg;
  i = segment(i, m, seg, n);
  if (n < 36) fail(E_DAMAGED, i);
  if (u16(seg) & 0x4000) fail(E_HT);
  Codestream out;
  out.x1 = u32(seg + 2);
  out.y1 = u32(seg + 6);
  out.x0 = u32(seg + 10);
  out.y0 = u32(seg + 14);
  out.tdx = u32(seg + 18);
  out.tdy = u32(seg + 22);
  out.tx0 = u32(seg + 26);
  out.ty0 = u32(seg + 30);
  int ncomp = u16(seg + 34);
  if (ncomp < 1 || ncomp > 16384 || n < 36 + 3 * ncomp) fail(E_DAMAGED, i);
  for (int c = 0; c < ncomp; ++c) {
    const uint8_t* s = seg + 36 + 3 * c;
    Component k{(s[0] & 0x7F) + 1, (s[0] & 0x80) ? 1 : 0, s[1], s[2]};
    if (k.prec > 16) fail(E_UNSUPPORTED);
    if (!k.dx || !k.dy) fail(E_DAMAGED);
    out.comps.push_back(k);
  }
  if (!(out.x0 < out.x1 && out.y0 < out.y1 && out.tdx && out.tdy &&
        out.tx0 <= out.x0 && out.ty0 <= out.y0 && out.tx0 + out.tdx > out.x0 &&
        out.ty0 + out.tdy > out.y0))
    fail(E_DAMAGED, i);
  Defaults main;
  std::vector<std::pair<int, std::vector<uint8_t>>> ppm;
  while (true) {
    if (i + 2 > len) fail(E_DAMAGED, i);
    if (u16(cs + i) == 0xFF90) break;
    i = segment(i, m, seg, n);
    header_marker(m, seg, n, main, ncomp, true, nullptr, &ppm);
  }
  if (!main.has_cod || !main.has_qcd) fail(E_DAMAGED, i);
  int64_t ntiles = out.across() * out.down();
  if (ntiles > (1 << 20)) fail(E_UNSUPPORTED);
  out.tiles.resize(ntiles);
  std::vector<Defaults> tdef(ntiles);
  std::vector<char> seen(ntiles, 0);
  while (true) {
    if (i + 2 > len) fail(E_NO_EOC, i);
    m = u16(cs + i);
    if (m == 0xFFD9) break;
    if (m != 0xFF90) fail(E_DAMAGED, i);
    int64_t start = i;
    i = segment(i, m, seg, n);
    if (n != 8) fail(E_DAMAGED, start);
    int isot = u16(seg);
    uint32_t psot = u32(seg + 2);
    if (isot >= ntiles) fail(E_DAMAGED, start);
    int64_t end = psot ? start + psot : len - 2;
    if (end > len || end < i) fail(E_DAMAGED, start);
    Tile& t = out.tiles[isot];
    if (!seen[isot]) {
      seen[isot] = 1;
      t.index = isot;
    }
    while (true) {
      if (i + 2 > end) fail(E_DAMAGED, i);
      if (u16(cs + i) == 0xFF93) {
        i += 2;
        break;
      }
      i = segment(i, m, seg, n);
      if ((m == 0xFF52 || m == 0xFF53 || m == 0xFF5C || m == 0xFF5D ||
           m == 0xFF5E) && t.parts)
        fail(E_DAMAGED, i);
      header_marker(m, seg, n, tdef[isot], ncomp, false, &t, nullptr);
    }
    t.data.insert(t.data.end(), cs + i, cs + end);
    t.parts++;
    i = end;
  }
  for (int64_t k = 0; k < ntiles; ++k)
    if (!seen[k]) fail(E_DAMAGED);
  if (!ppm.empty()) {
    std::stable_sort(ppm.begin(), ppm.end(), [](const auto& a, const auto& b) {
      return a.first < b.first;
    });
    for (size_t z = 0; z < ppm.size(); ++z)
      if (ppm[z].first != (int)z) fail(E_DAMAGED);
    int64_t remaining = 0;
    for (auto& pr : ppm) {
      const std::vector<uint8_t>& d = pr.second;
      size_t at = 0;
      while (at < d.size()) {
        if (remaining) {
          int64_t take = std::min<int64_t>(remaining, d.size() - at);
          out.ppm.insert(out.ppm.end(), d.begin() + at, d.begin() + at + take);
          remaining -= take;
          at += take;
          continue;
        }
        if (at + 4 > d.size()) fail(E_DAMAGED);
        remaining = u32(d.data() + at);
        at += 4;
      }
    }
    if (remaining) fail(E_DAMAGED);
    out.has_ppm = true;
  }
  for (int64_t k = 0; k < ntiles; ++k) {
    Tile& t = out.tiles[k];
    const Defaults& d = tdef[k];
    const Defaults& c = d.has_cod ? d : main;
    t.order = c.order;
    t.layers = c.layers;
    t.mct = c.mct;
    t.sop = c.sop;
    t.eph = c.eph;
    for (int q = 0; q < ncomp; ++q) t.comps.push_back(coding_for(q, d, main));
    t.pocs = d.pocs.empty() ? main.pocs : d.pocs;
    if (t.mct && ncomp < 3) fail(E_DAMAGED);
    if (out.has_ppm && !t.ppt.empty()) fail(E_DAMAGED);
  }
  return out;
}

// ---------------------------------------------------------------------------
// geometry (opj_tcd_init_tile)
// ---------------------------------------------------------------------------
struct Rect { int64_t x0, y0, x1, y1; };
struct Precinct { Rect r; int cw, ch; std::vector<Rect> blocks; };
struct Band {
  int number;
  Rect r;
  int expn, mant, numbps;
  std::vector<Precinct> precincts;
  bool empty() const { return r.x0 >= r.x1 || r.y0 >= r.y1; }
};
struct Resolution { Rect r; int pdx, pdy, pw, ph; std::vector<Band> bands; };
struct TileComp { Rect r; std::vector<Resolution> res; };

Rect tile_rect(const Codestream& cs, int64_t index) {
  int64_t p = index % cs.across(), q = index / cs.across();
  return {std::max(cs.tx0 + p * cs.tdx, cs.x0),
          std::max(cs.ty0 + q * cs.tdy, cs.y0),
          std::min(cs.tx0 + (p + 1) * cs.tdx, cs.x1),
          std::min(cs.ty0 + (q + 1) * cs.tdy, cs.y1)};
}

std::vector<TileComp> tile_geometry(const Codestream& cs, const Tile& t) {
  Rect tr = tile_rect(cs, t.index);
  std::vector<TileComp> out;
  for (size_t c = 0; c < cs.comps.size(); ++c) {
    const Component& comp = cs.comps[c];
    const Coding& k = t.comps[c];
    TileComp tc;
    tc.r = {ceildiv(tr.x0, comp.dx), ceildiv(tr.y0, comp.dy),
            ceildiv(tr.x1, comp.dx), ceildiv(tr.y1, comp.dy)};
    if (tc.r.x1 - tc.r.x0 < 1 || tc.r.y1 - tc.r.y0 < 1) fail(E_DAMAGED);
    int nres = k.levels + 1;
    for (int r = 0; r < nres; ++r) {
      int level = nres - 1 - r;
      Resolution res;
      res.r = {cdp2(tc.r.x0, level), cdp2(tc.r.y0, level),
               cdp2(tc.r.x1, level), cdp2(tc.r.y1, level)};
      res.pdx = k.precincts[r].first;
      res.pdy = k.precincts[r].second;
      int64_t px0 = (res.r.x0 >> res.pdx) << res.pdx;
      int64_t py0 = (res.r.y0 >> res.pdy) << res.pdy;
      int64_t px1 = cdp2(res.r.x1, res.pdx) << res.pdx;
      int64_t py1 = cdp2(res.r.y1, res.pdy) << res.pdy;
      res.pw = res.r.x0 == res.r.x1 ? 0 : (int)((px1 - px0) >> res.pdx);
      res.ph = res.r.y0 == res.r.y1 ? 0 : (int)((py1 - py0) >> res.pdy);
      if ((int64_t)res.pw * res.ph > (1 << 24)) fail(E_UNSUPPORTED);
      int64_t gx0, gy0;
      int gw, gh;
      if (r == 0) {
        gx0 = px0; gy0 = py0; gw = res.pdx; gh = res.pdy;
      } else {
        gx0 = cdp2(px0, 1); gy0 = cdp2(py0, 1);
        gw = res.pdx - 1; gh = res.pdy - 1;
      }
      int cbw = std::min(k.cbw, gw), cbh = std::min(k.cbh, gh);
      int first = r == 0 ? 0 : 1, last = r == 0 ? 0 : 3;
      for (int number = first; number <= last; ++number) {
        Band b;
        b.number = number;
        int index;
        if (r == 0) {
          b.r = {cdp2(tc.r.x0, level), cdp2(tc.r.y0, level),
                 cdp2(tc.r.x1, level), cdp2(tc.r.y1, level)};
          index = 0;
        } else {
          int64_t xb = number & 1, yb = number >> 1;
          b.r = {cdp2(tc.r.x0 - (xb << level), level + 1),
                 cdp2(tc.r.y0 - (yb << level), level + 1),
                 cdp2(tc.r.x1 - (xb << level), level + 1),
                 cdp2(tc.r.y1 - (yb << level), level + 1)};
          index = 3 * (r - 1) + number;
        }
        auto st = k.step(index);
        b.expn = st.first;
        b.mant = st.second;
        b.numbps = b.expn + k.guard - 1;
        for (int64_t q = 0; q < (int64_t)res.pw * res.ph; ++q) {
          int64_t sx = gx0 + (q % res.pw) * ((int64_t)1 << gw);
          int64_t sy = gy0 + (q / res.pw) * ((int64_t)1 << gh);
          Precinct p;
          p.r = {std::max(sx, b.r.x0), std::max(sy, b.r.y0),
                 std::min(sx + ((int64_t)1 << gw), b.r.x1),
                 std::min(sy + ((int64_t)1 << gh), b.r.y1)};
          int64_t bx0 = (p.r.x0 >> cbw) << cbw, by0 = (p.r.y0 >> cbh) << cbh;
          int64_t bx1 = cdp2(p.r.x1, cbw) << cbw, by1 = cdp2(p.r.y1, cbh) << cbh;
          p.cw = (int)std::max<int64_t>((bx1 - bx0) >> cbw, 0);
          p.ch = (int)std::max<int64_t>((by1 - by0) >> cbh, 0);
          for (int64_t j = 0; j < (int64_t)p.cw * p.ch; ++j) {
            int64_t x = bx0 + (j % p.cw) * ((int64_t)1 << cbw);
            int64_t y = by0 + (j / p.cw) * ((int64_t)1 << cbh);
            p.blocks.push_back({std::max(x, p.r.x0), std::max(y, p.r.y0),
                                std::min(x + ((int64_t)1 << cbw), p.r.x1),
                                std::min(y + ((int64_t)1 << cbh), p.r.y1)});
          }
          b.precincts.push_back(std::move(p));
        }
        res.bands.push_back(std::move(b));
      }
      tc.res.push_back(std::move(res));
    }
    out.push_back(std::move(tc));
  }
  return out;
}

// ---------------------------------------------------------------------------
// tier-2
// ---------------------------------------------------------------------------
struct Bits {
  const uint8_t* data;
  int64_t pos, end;
  uint32_t buf = 0;
  int ct = 0;
  Bits(const uint8_t* d, int64_t p, int64_t e) : data(d), pos(p), end(e) {}
  void bytein() {
    buf = (buf << 8) & 0xFFFF;
    ct = buf == 0xFF00 ? 7 : 8;
    if (pos < end) buf |= data[pos++];
  }
  int bit() {
    if (ct == 0) bytein();
    --ct;
    return (buf >> ct) & 1;
  }
  uint32_t bits(int n) {
    uint32_t v = 0;
    for (int i = 0; i < n; ++i) v = (v << 1) | bit();
    return v;
  }
  void align() {
    if ((buf & 0xFF) == 0xFF) bytein();
    ct = 0;
  }
};

struct TagTree {
  std::vector<int> parent, value, low;
  TagTree(int w, int h) {
    std::vector<std::array<int, 3>> levels;
    int n = 0;
    while (true) {
      levels.push_back({w, h, n});
      n += w * h;
      if (w * h <= 1) break;
      w = (w + 1) / 2;
      h = (h + 1) / 2;
    }
    parent.assign(n, -1);
    value.assign(n, 999);
    low.assign(n, 0);
    for (size_t k = 0; k + 1 < levels.size(); ++k) {
      int lw = levels[k][0], lh = levels[k][1], base = levels[k][2];
      int pw = levels[k + 1][0], pbase = levels[k + 1][2];
      for (int j = 0; j < lh; ++j)
        for (int i = 0; i < lw; ++i)
          parent[base + j * lw + i] = pbase + (j >> 1) * pw + (i >> 1);
    }
  }
  int decode(Bits& bio, int leaf, int threshold) {
    int stack[64], sp = 0, node = leaf;
    while (parent[node] >= 0) {
      stack[sp++] = node;
      node = parent[node];
    }
    int lo = 0;
    while (true) {
      if (lo > low[node]) low[node] = lo;
      else lo = low[node];
      while (lo < threshold && lo < value[node]) {
        if (bio.bit()) value[node] = lo;
        else ++lo;
      }
      low[node] = lo;
      if (!sp) break;
      node = stack[--sp];
    }
    return value[node] < threshold ? 1 : 0;
  }
};

struct Block {
  Rect r;
  int numbps = 0, numlenbits = 3, numsegs = 0;
  std::vector<std::array<int64_t, 3>> segs;  // maxpasses, passes, length
  std::vector<uint8_t> data;
};

struct PrecBand {
  const Band* band;
  TagTree incl, msb;
  std::vector<Block> blocks;
};

struct PrecState { std::vector<PrecBand> bands; };

void init_seg(Block& b, int index, int style, bool first) {
  while ((int)b.segs.size() <= index) b.segs.push_back({0, 0, 0});
  int64_t maxp;
  if (style & 4) maxp = 1;
  else if (style & 1) {
    if (first) maxp = 10;
    else {
      int64_t prev = b.segs[index - 1][0];
      maxp = (prev == 1 || prev == 10) ? 2 : 1;
    }
  } else maxp = 109;
  b.segs[index] = {maxp, 0, 0};
}

int numpasses(Bits& bio) {
  if (!bio.bit()) return 1;
  if (!bio.bit()) return 2;
  int n = bio.bits(2);
  if (n != 3) return 3 + n;
  n = bio.bits(5);
  if (n != 31) return 6 + n;
  return 37 + bio.bits(7);
}

bool position_ok(int64_t v, int64_t t0, int64_t tr0, int64_t d, int level,
                 int rp) {
  return (v % (d << rp)) == 0 ||
         (v == t0 && ((tr0 << level) % ((int64_t)1 << rp)) != 0);
}

struct Packet { int layer, res, comp, prec; };

std::vector<Packet> packet_order(const Codestream& cs, const Tile& t,
                                 const std::vector<TileComp>& g) {
  Rect tr = tile_rect(cs, t.index);
  int ncomp = (int)cs.comps.size();
  std::vector<int> nres(ncomp);
  int maxres = 0, maxprec = 1;
  for (int c = 0; c < ncomp; ++c) {
    nres[c] = t.comps[c].levels + 1;
    maxres = std::max(maxres, nres[c]);
    for (auto& res : g[c].res) maxprec = std::max(maxprec, res.pw * res.ph);
  }
  std::vector<std::vector<int>> changes;
  if (!t.pocs.empty()) {
    for (auto& p : t.pocs)
      changes.push_back({p[0], p[1], std::min(p[2], t.layers), p[3],
                         std::min(p[4], ncomp), p[5]});
  } else {
    changes.push_back({0, 0, t.layers, maxres, ncomp, t.order});
  }
  int64_t dx = 0, dy = 0;
  for (int c = 0; c < ncomp; ++c)
    for (int r = 0; r < nres[c]; ++r) {
      int level = nres[c] - 1 - r;
      const Resolution& res = g[c].res[r];
      if (res.pdx + level < 32) {
        int64_t v = (int64_t)cs.comps[c].dx << (res.pdx + level);
        dx = dx ? std::min(dx, v) : v;
      }
      if (res.pdy + level < 32) {
        int64_t v = (int64_t)cs.comps[c].dy << (res.pdy + level);
        dy = dy ? std::min(dy, v) : v;
      }
    }
  std::vector<uint8_t> seen((size_t)t.layers * maxres * ncomp * maxprec, 0);
  std::vector<Packet> out;
  auto emit = [&](int l0, int l1, int r, int c, int p) {
    for (int l = l0; l < l1; ++l) {
      size_t key = (((size_t)l * maxres + r) * ncomp + c) * maxprec + p;
      if (!seen[key]) {
        seen[key] = 1;
        out.push_back({l, r, c, p});
      }
    }
  };
  auto precinct_at = [&](int c, int r, int64_t x, int64_t y) -> int {
    if (r >= nres[c]) return -1;
    const Component& comp = cs.comps[c];
    const Resolution& res = g[c].res[r];
    int level = nres[c] - 1 - r;
    int64_t trx0 = ceildiv(tr.x0, (int64_t)comp.dx << level);
    int64_t try0 = ceildiv(tr.y0, (int64_t)comp.dy << level);
    int64_t trx1 = ceildiv(tr.x1, (int64_t)comp.dx << level);
    int64_t try1 = ceildiv(tr.y1, (int64_t)comp.dy << level);
    int rpx = res.pdx + level, rpy = res.pdy + level;
    if (rpx >= 31 || rpy >= 31) return -1;
    if (!position_ok(y, tr.y0, try0, comp.dy, level, rpy)) return -1;
    if (!position_ok(x, tr.x0, trx0, comp.dx, level, rpx)) return -1;
    if (res.pw == 0 || res.ph == 0 || trx0 == trx1 || try0 == try1) return -1;
    int64_t prci = (ceildiv(x, (int64_t)comp.dx << level) >> res.pdx) -
                   (trx0 >> res.pdx);
    int64_t prcj = (ceildiv(y, (int64_t)comp.dy << level) >> res.pdy) -
                   (try0 >> res.pdy);
    return (int)(prci + prcj * res.pw);
  };
  auto positions = [&](int64_t sx, int64_t sy, auto&& body) {
    for (int64_t y = tr.y0; y < tr.y1; y += sy - (y % sy))
      for (int64_t x = tr.x0; x < tr.x1; x += sx - (x % sx)) body(x, y);
  };
  for (auto& ch : changes) {
    int r0 = ch[0], c0 = ch[1], l1 = ch[2], r1 = ch[3], c1 = ch[4], prg = ch[5];
    if (prg == 0 || prg == 1) {
      int outer = prg == 0 ? l1 : r1;
      for (int a = prg == 0 ? 0 : r0; a < outer; ++a) {
        int inner0 = prg == 0 ? r0 : 0, inner1 = prg == 0 ? r1 : l1;
        for (int b = inner0; b < inner1; ++b) {
          int l = prg == 0 ? a : b, r = prg == 0 ? b : a;
          for (int c = c0; c < c1; ++c) {
            if (r >= nres[c]) continue;
            const Resolution& res = g[c].res[r];
            for (int p = 0; p < res.pw * res.ph; ++p) emit(l, l + 1, r, c, p);
          }
        }
      }
    } else if (prg == 2) {
      if (!dx || !dy) fail(E_DAMAGED);
      for (int r = r0; r < r1; ++r)
        positions(dx, dy, [&](int64_t x, int64_t y) {
          for (int c = c0; c < c1; ++c) {
            int p = precinct_at(c, r, x, y);
            if (p >= 0) emit(0, l1, r, c, p);
          }
        });
    } else if (prg == 3) {
      if (!dx || !dy) fail(E_DAMAGED);
      positions(dx, dy, [&](int64_t x, int64_t y) {
        for (int c = c0; c < c1; ++c)
          for (int r = r0; r < r1; ++r) {
            int p = precinct_at(c, r, x, y);
            if (p >= 0) emit(0, l1, r, c, p);
          }
      });
    } else {
      for (int c = c0; c < c1; ++c) {
        int64_t cdx = 0, cdy = 0;
        for (int r = 0; r < nres[c]; ++r) {
          int level = nres[c] - 1 - r;
          const Resolution& res = g[c].res[r];
          if (res.pdx + level < 32) {
            int64_t v = (int64_t)cs.comps[c].dx << (res.pdx + level);
            cdx = cdx ? std::min(cdx, v) : v;
          }
          if (res.pdy + level < 32) {
            int64_t v = (int64_t)cs.comps[c].dy << (res.pdy + level);
            cdy = cdy ? std::min(cdy, v) : v;
          }
        }
        if (!cdx || !cdy) fail(E_DAMAGED);
        positions(cdx, cdy, [&](int64_t x, int64_t y) {
          for (int r = r0; r < std::min(r1, nres[c]); ++r) {
            int p = precinct_at(c, r, x, y);
            if (p >= 0) emit(0, l1, r, c, p);
          }
        });
      }
    }
  }
  return out;
}

struct HeaderSource { const std::vector<uint8_t>* data; int64_t pos; };

std::map<int64_t, PrecState> read_packets(const Codestream& cs, const Tile& t,
                                          const std::vector<TileComp>& g,
                                          HeaderSource* ppm) {
  const uint8_t* data = t.data.data();
  int64_t end = (int64_t)t.data.size(), pos = 0;
  std::vector<uint8_t> pptdata;
  HeaderSource ppt{&pptdata, 0};
  HeaderSource* heads = ppm;
  if (!heads && !t.ppt.empty()) {
    auto parts = t.ppt;
    std::stable_sort(parts.begin(), parts.end(),
                     [](const auto& a, const auto& b) { return a.first < b.first; });
    for (auto& p : parts) pptdata.insert(pptdata.end(), p.second.begin(),
                                         p.second.end());
    heads = &ppt;
  }
  std::map<int64_t, PrecState> precincts;
  int ncomp = (int)cs.comps.size();
  struct News { Block* blk; std::vector<std::array<int64_t, 3>> segs; };
  for (const Packet& pk : packet_order(cs, t, g)) {
    int64_t key = ((int64_t)pk.prec * MAX_RES + pk.res) * ncomp + pk.comp;
    auto it = precincts.find(key);
    if (it == precincts.end()) {
      PrecState st;
      for (const Band& band : g[pk.comp].res[pk.res].bands) {
        if (band.empty()) continue;
        const Precinct& p = band.precincts[pk.prec];
        PrecBand pb{&band, TagTree(std::max(p.cw, 1), std::max(p.ch, 1)),
                    TagTree(std::max(p.cw, 1), std::max(p.ch, 1)), {}};
        for (const Rect& r : p.blocks) {
          Block b;
          b.r = r;
          pb.blocks.push_back(std::move(b));
        }
        st.bands.push_back(std::move(pb));
      }
      it = precincts.emplace(key, std::move(st)).first;
    }
    PrecState& prc = it->second;
    const Coding& coding = t.comps[pk.comp];
    if (t.sop) {
      if (end - pos < 6 || data[pos] != 0xFF || data[pos + 1] != 0x91)
        fail(E_SOP_EPH, pos);
      pos += 6;
    }
    const uint8_t* src;
    int64_t hpos, hend;
    if (heads) {
      src = heads->data->data();
      hpos = heads->pos;
      hend = (int64_t)heads->data->size();
    } else {
      src = data;
      hpos = pos;
      hend = end;
    }
    Bits bio(src, hpos, hend);
    std::vector<News> included;
    if (bio.bit()) {
      for (PrecBand& pb : prc.bands) {
        for (size_t k = 0; k < pb.blocks.size(); ++k) {
          Block& blk = pb.blocks[k];
          int inc = blk.numsegs ? bio.bit()
                                : pb.incl.decode(bio, (int)k, pk.layer + 1);
          if (!inc) continue;
          if (!blk.numsegs) {
            int i = 0;
            while (!pb.msb.decode(bio, (int)k, i)) {
              ++i;
              if (i > 64) fail(E_DAMAGED, pos);
            }
            blk.numbps = pb.band->numbps + 1 - i;
            blk.numlenbits = 3;
          }
          int n = numpasses(bio);
          while (bio.bit()) {
            blk.numlenbits++;
            if (blk.numlenbits > 64) fail(E_DAMAGED, pos);
          }
          int segno;
          if (!blk.numsegs) {
            segno = 0;
            init_seg(blk, 0, coding.style, true);
          } else {
            segno = blk.numsegs - 1;
            if (blk.segs[segno][1] == blk.segs[segno][0]) {
              ++segno;
              init_seg(blk, segno, coding.style, false);
            }
          }
          News nw{&blk, {}};
          while (true) {
            auto& seg = blk.segs[segno];
            int64_t take = std::min<int64_t>(seg[0] - seg[1], n);
            int nbits = blk.numlenbits + (63 - __builtin_clzll((uint64_t)take));
            if (nbits > 32) fail(E_DAMAGED, pos);
            nw.segs.push_back({segno, take, (int64_t)bio.bits(nbits)});
            n -= (int)take;
            if (n <= 0) break;
            ++segno;
            init_seg(blk, segno, coding.style, false);
          }
          included.push_back(std::move(nw));
        }
      }
    }
    bio.align();
    hpos = bio.pos;
    if (t.eph) {
      if (hend - hpos < 2 || src[hpos] != 0xFF || src[hpos + 1] != 0x92)
        fail(E_SOP_EPH, pos);
      hpos += 2;
    }
    if (heads) heads->pos = hpos;
    else pos = hpos;
    for (News& nw : included) {
      Block& blk = *nw.blk;
      for (auto& s : nw.segs) {
        int64_t segno = s[0], take = s[1], length = s[2];
        if (pos + length > end) fail(E_DAMAGED, pos);
        blk.data.insert(blk.data.end(), data + pos, data + pos + length);
        pos += length;
        blk.segs[segno][1] += take;
        blk.segs[segno][2] += length;
        blk.numsegs = std::max<int>(blk.numsegs, (int)segno + 1);
      }
    }
  }
  return precincts;
}

// ---------------------------------------------------------------------------
// tier-1
// ---------------------------------------------------------------------------
const uint16_t QE[47] = {
    0x5601, 0x3401, 0x1801, 0x0AC1, 0x0521, 0x0221, 0x5601, 0x5401, 0x4801,
    0x3801, 0x3001, 0x2401, 0x1C01, 0x1601, 0x5601, 0x5401, 0x5101, 0x4801,
    0x3801, 0x3401, 0x3001, 0x2801, 0x2401, 0x2201, 0x1C01, 0x1801, 0x1601,
    0x1401, 0x1201, 0x1101, 0x0AC1, 0x09C1, 0x08A1, 0x0521, 0x0441, 0x02A1,
    0x0221, 0x0141, 0x0111, 0x0085, 0x0049, 0x0025, 0x0015, 0x0009, 0x0005,
    0x0001, 0x5601};
const uint8_t NMPS[47] = {1,  2,  3,  4,  5,  38, 7,  8,  9,  10, 11, 12,
                          13, 29, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24,
                          25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36,
                          37, 38, 39, 40, 41, 42, 43, 44, 45, 45, 46};
const uint8_t NLPS[47] = {1,  6,  9,  12, 29, 33, 6,  14, 14, 14, 17, 18,
                          20, 21, 14, 14, 15, 16, 17, 18, 19, 19, 20, 21,
                          22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33,
                          34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 46};
const uint8_t SWITCH[47] = {1, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 1};
constexpr int CTX_MAG = 14, CTX_AGG = 17, CTX_UNI = 18;

struct MQ {
  std::vector<uint8_t> buf;
  int64_t pos = 0;
  uint32_t a = 0, c = 0;
  int ct = 0;
  uint8_t state[19], mps[19];
  MQ() { reset(); }
  void reset() {
    memset(state, 0, sizeof state);
    memset(mps, 0, sizeof mps);
    state[CTX_UNI] = 46;
    state[CTX_AGG] = 3;
    state[0] = 4;
  }
  void load(const uint8_t* d, int64_t n) {
    buf.assign(d, d + n);
    buf.push_back(0xFF);
    buf.push_back(0xFF);
    pos = 0;
  }
  void bytein() {
    if (buf[pos] == 0xFF) {
      if (buf[pos + 1] > 0x8F) {
        c += 0xFF00;
        ct = 8;
      } else {
        ++pos;
        c += (uint32_t)buf[pos] << 9;
        ct = 7;
      }
    } else {
      ++pos;
      c += (uint32_t)buf[pos] << 8;
      ct = 8;
    }
  }
  void start(const uint8_t* d, int64_t n) {
    load(d, n);
    c = n ? (uint32_t)buf[0] << 16 : 0xFFu << 16;
    ct = 0;
    bytein();
    c <<= 7;
    ct -= 7;
    a = 0x8000;
  }
  void start_raw(const uint8_t* d, int64_t n) {
    load(d, n);
    c = 0;
    ct = 0;
  }
  int decode(int cx) {
    int s = state[cx];
    uint32_t qe = QE[s];
    int d;
    a -= qe;
    if ((c >> 16) < qe) {
      if (a < qe) {
        d = mps[cx];
        state[cx] = NMPS[s];
      } else {
        d = 1 - mps[cx];
        if (SWITCH[s]) mps[cx] = d;
        state[cx] = NLPS[s];
      }
      a = qe;
    } else {
      c -= qe << 16;
      if (a & 0x8000) return mps[cx];
      if (a < qe) {
        d = 1 - mps[cx];
        if (SWITCH[s]) mps[cx] = d;
        state[cx] = NLPS[s];
      } else {
        d = mps[cx];
        state[cx] = NMPS[s];
      }
    }
    do {
      if (ct == 0) bytein();
      a <<= 1;
      c <<= 1;
      --ct;
    } while (a < 0x8000);
    return d;
  }
  int raw() {
    if (ct == 0) {
      if (c == 0xFF) {
        if (buf[pos] > 0x8F) {
          c = 0xFF;
          ct = 8;
        } else {
          c = buf[pos++];
          ct = 7;
        }
      } else {
        c = buf[pos++];
        ct = 8;
      }
    }
    --ct;
    return (c >> ct) & 1;
  }
};

int ZC[4][45];
const int SCX[9][2] = {{13, 1}, {12, 1}, {11, 1}, {10, 1}, {9, 0},
                       {10, 0}, {11, 0}, {12, 0}, {13, 0}};

void init_tables() {
  static bool done = false;
  if (done) return;
  for (int o = 0; o < 4; ++o)
    for (int h = 0; h < 3; ++h)
      for (int v = 0; v < 3; ++v)
        for (int d = 0; d < 5; ++d) {
          int n;
          if (o == 3) {
            int hv = h + v;
            if (d >= 3) n = 8;
            else if (d == 2) n = hv ? 7 : 6;
            else if (d == 1) n = hv >= 2 ? 5 : hv ? 4 : 3;
            else n = hv >= 2 ? 2 : hv;
          } else {
            int a = o == 1 ? v : h, b = o == 1 ? h : v;
            if (a == 2) n = 8;
            else if (a == 1) n = b ? 7 : (d ? 6 : 5);
            else n = b == 2 ? 4 : b == 1 ? 3 : d >= 2 ? 2 : d;
          }
          ZC[o][h * 15 + v * 5 + d] = n;
        }
  done = true;
}

// a code-block's values (OpenJPEG's t1 data) into out[h * w]
void decode_block(int w, int h, int orient, const Block& blk, int roishift,
                  int style, std::vector<int32_t>& out) {
  out.assign((size_t)w * h, 0);
  if (!w || !h || !blk.numsegs) return;
  const int S = w + 2;
  size_t size = (size_t)S * (h + 2);
  std::vector<uint8_t> sig(size, 0), neg(size, 0), vis(size, 0), mu(size, 0);
  std::vector<int32_t> val(size, 0);
  int bpno = roishift + blk.numbps;
  if (bpno >= 31) fail(E_DAMAGED);
  const int* zc = ZC[orient];
  const bool vsc = style & 8;
  MQ mq;
  int passtype = 2;
  auto south_of = [&](int y) { return !(vsc && (y & 3) == 3); };
  auto zc_ctx = [&](size_t p, bool south) {
    int hh = sig[p - 1] + sig[p + 1];
    int vv = sig[p - S];
    int dd = sig[p - S - 1] + sig[p - S + 1];
    if (south) {
      vv += sig[p + S];
      dd += sig[p + S - 1] + sig[p + S + 1];
    }
    return zc[hh * 15 + vv * 5 + dd];
  };
  auto contrib = [&](size_t q) { return sig[q] ? (neg[q] ? -1 : 1) : 0; };
  auto sign = [&](size_t p, bool south, bool raw) {
    if (raw) return mq.raw();
    int hc = contrib(p - 1) + contrib(p + 1);
    int vc = contrib(p - S) + (south ? contrib(p + S) : 0);
    hc = hc > 0 ? 1 : hc < 0 ? -1 : 0;
    vc = vc > 0 ? 1 : vc < 0 ? -1 : 0;
    const int* e = SCX[(hc + 1) * 3 + vc + 1];
    return mq.decode(e[0]) ^ e[1];
  };
  auto neighbours = [&](size_t p, bool south) {
    if (sig[p - 1] | sig[p + 1] | sig[p - S] | sig[p - S - 1] | sig[p - S + 1])
      return true;
    return south && (sig[p + S] | sig[p + S - 1] | sig[p + S + 1]);
  };
  int64_t at = 0;
  for (int sg = 0; sg < blk.numsegs; ++sg) {
    int64_t passes = blk.segs[sg][1], len = blk.segs[sg][2];
    bool raw = (style & 1) && passtype < 2 && bpno <= blk.numbps - 4;
    if (raw) mq.start_raw(blk.data.data() + at, len);
    else mq.start(blk.data.data() + at, len);
    at += len;
    for (int64_t pn = 0; pn < passes && bpno >= 1; ++pn) {
      int32_t one = 1 << bpno, half = one >> 1, oph = one | half;
      for (int y0 = 0; y0 < h; y0 += 4) {
        int rows = std::min(4, h - y0);
        for (int x = 0; x < w; ++x) {
          size_t p0 = (size_t)(y0 + 1) * S + x + 1;
          if (passtype == 0) {
            for (int k = 0; k < rows; ++k) {
              size_t p = p0 + (size_t)k * S;
              bool south = south_of(y0 + k);
              if (sig[p] || !neighbours(p, south)) continue;
              int v = raw ? mq.raw() : mq.decode(zc_ctx(p, south));
              if (v) {
                int s = sign(p, south, raw);
                val[p] = s ? -oph : oph;
                sig[p] = 1;
                neg[p] = s;
              }
              vis[p] = 1;
            }
          } else if (passtype == 1) {
            for (int k = 0; k < rows; ++k) {
              size_t p = p0 + (size_t)k * S;
              if (!sig[p] || vis[p]) continue;
              int v;
              if (raw) v = mq.raw();
              else {
                int cx = mu[p] ? CTX_MAG + 2
                               : neighbours(p, south_of(y0 + k)) ? CTX_MAG + 1
                                                                 : CTX_MAG;
                v = mq.decode(cx);
              }
              val[p] += (v ^ (val[p] < 0)) ? half : -half;
              mu[p] = 1;
            }
          } else {
            int k = 0;
            bool run = rows == 4;
            for (int q = 0; q < 4 && run; ++q) {
              size_t p = p0 + (size_t)q * S;
              if (sig[p] || vis[p] || neighbours(p, south_of(y0 + q)))
                run = false;
            }
            bool skip = false;
            if (run) {
              if (!mq.decode(CTX_AGG)) {
                skip = true;
              } else {
                k = mq.decode(CTX_UNI) << 1;
                k |= mq.decode(CTX_UNI);
                size_t p = p0 + (size_t)k * S;
                int s = sign(p, south_of(y0 + k), false);
                val[p] = s ? -oph : oph;
                sig[p] = 1;
                neg[p] = s;
                ++k;
              }
            }
            if (!skip) {
              for (; k < rows; ++k) {
                size_t p = p0 + (size_t)k * S;
                if (sig[p] || vis[p]) continue;
                bool south = south_of(y0 + k);
                if (mq.decode(zc_ctx(p, south))) {
                  int s = sign(p, south, false);
                  val[p] = s ? -oph : oph;
                  sig[p] = 1;
                  neg[p] = s;
                }
              }
            }
            for (int q = 0; q < rows; ++q) vis[p0 + (size_t)q * S] = 0;
          }
        }
      }
      if (passtype == 2 && (style & 32))
        for (int q = 0; q < 4; ++q) mq.decode(CTX_UNI);
      if ((style & 2) && !raw) mq.reset();
      if (++passtype == 3) {
        passtype = 0;
        --bpno;
      }
    }
  }
  for (int y = 0; y < h; ++y)
    for (int x = 0; x < w; ++x) {
      int32_t v = val[(size_t)(y + 1) * S + x + 1];
      if (roishift) {
        if (roishift >= 31) v = 0;
        else {
          int64_t mag = v < 0 ? -(int64_t)v : v;
          if (mag >= ((int64_t)1 << roishift)) {
            mag >>= roishift;
            v = (int32_t)(v < 0 ? -mag : mag);
          }
        }
      }
      out[(size_t)y * w + x] = v;
    }
}

float band_step(const Component& comp, const Band& b) {
  double step = (1.0 + b.mant / 2048.0) *
                std::pow(2.0, (double)(comp.prec - b.expn));
  return (float)step;
}

struct Sizes { int64_t coeffs = 0, tcs = 0, tiles = 0; };

Sizes sizes_of(const Codestream& cs) {
  Sizes s;
  s.tiles = (int64_t)cs.tiles.size();
  for (const Tile& t : cs.tiles) {
    Rect tr = tile_rect(cs, t.index);
    for (const Component& comp : cs.comps) {
      int64_t w = ceildiv(tr.x1, comp.dx) - ceildiv(tr.x0, comp.dx);
      int64_t h = ceildiv(tr.y1, comp.dy) - ceildiv(tr.y0, comp.dy);
      if (w < 1 || h < 1) fail(E_DAMAGED);
      s.coeffs += w * h;
      s.tcs += 1;
    }
  }
  return s;
}

}  // namespace

extern "C" int j2k_decode(const uint8_t* data, int64_t len, int32_t* coeffs,
                          int64_t cap_coeffs, int32_t* tcs, int cap_tcs,
                          int32_t* tiles, int cap_tiles, int64_t* info) {
  try {
    init_tables();
    Codestream cs = parse(data, len);
    Sizes s = sizes_of(cs);
    info[0] = s.coeffs;
    info[1] = s.tcs;
    info[2] = s.tiles;
    info[3] = (int64_t)cs.comps.size();
    info[4] = cs.x1; info[5] = cs.y1; info[6] = cs.x0; info[7] = cs.y0;
    info[8] = cs.tx0; info[9] = cs.ty0; info[10] = cs.tdx; info[11] = cs.tdy;
    if (s.coeffs > ((int64_t)1 << 31) - 1) return E_UNSUPPORTED;
    if (!coeffs || cap_coeffs < s.coeffs || !tcs || cap_tcs < s.tcs ||
        !tiles || cap_tiles < s.tiles)
      return E_NEED;
    HeaderSource ppm{&cs.ppm, 0};
    int64_t offset = 0, row = 0;
    std::vector<int32_t> values;
    for (size_t index = 0; index < cs.tiles.size(); ++index) {
      const Tile& t = cs.tiles[index];
      std::vector<TileComp> g = tile_geometry(cs, t);
      auto precincts = read_packets(cs, t, g, cs.has_ppm ? &ppm : nullptr);
      Rect tr = tile_rect(cs, t.index);
      int32_t* trow = tiles + index * TILE_COLS;
      trow[0] = (int32_t)tr.x0; trow[1] = (int32_t)tr.y0;
      trow[2] = (int32_t)tr.x1; trow[3] = (int32_t)tr.y1;
      trow[4] = t.mct; trow[5] = (int32_t)row;
      std::vector<int64_t> base(cs.comps.size());
      for (size_t c = 0; c < cs.comps.size(); ++c) {
        const TileComp& tc = g[c];
        int32_t* r = tcs + (row + c) * TC_COLS;
        memset(r, 0, sizeof(int32_t) * TC_COLS);
        int64_t w = tc.r.x1 - tc.r.x0, h = tc.r.y1 - tc.r.y0;
        r[0] = (int32_t)offset; r[1] = (int32_t)w; r[2] = (int32_t)h;
        r[3] = (int32_t)tc.r.x0; r[4] = (int32_t)tc.r.y0;
        r[5] = t.comps[c].levels; r[6] = t.comps[c].reversible;
        r[7] = (int32_t)c;
        for (size_t k = 0; k < tc.res.size(); ++k) {
          r[8 + 4 * k] = (int32_t)tc.res[k].r.x0;
          r[9 + 4 * k] = (int32_t)tc.res[k].r.y0;
          r[10 + 4 * k] = (int32_t)tc.res[k].r.x1;
          r[11 + 4 * k] = (int32_t)tc.res[k].r.y1;
        }
        memset(coeffs + offset, 0, sizeof(int32_t) * w * h);
        base[c] = offset;
        offset += w * h;
      }
      for (auto& kv : precincts) {
        int64_t key = kv.first;
        int c = (int)(key % (int64_t)cs.comps.size());
        int r = (int)((key / (int64_t)cs.comps.size()) % MAX_RES);
        const Coding& coding = t.comps[c];
        const TileComp& tc = g[c];
        int64_t stride = tc.r.x1 - tc.r.x0;
        for (const PrecBand& pb : kv.second.bands) {
          const Band& band = *pb.band;
          float half_step = coding.reversible
                                ? 0.0f
                                : 0.5f * band_step(cs.comps[c], band);
          for (const Block& blk : pb.blocks) {
            int bw = (int)(blk.r.x1 - blk.r.x0), bh = (int)(blk.r.y1 - blk.r.y0);
            if (bw <= 0 || bh <= 0 || !blk.numsegs) continue;
            decode_block(bw, bh, band.number, blk, coding.roishift,
                         coding.style, values);
            int64_t x = blk.r.x0 - band.r.x0, y = blk.r.y0 - band.r.y0;
            if (band.number & 1) x += tc.res[r - 1].r.x1 - tc.res[r - 1].r.x0;
            if (band.number & 2) y += tc.res[r - 1].r.y1 - tc.res[r - 1].r.y0;
            for (int j = 0; j < bh; ++j) {
              int32_t* dst = coeffs + base[c] + (y + j) * stride + x;
              const int32_t* src = values.data() + (size_t)j * bw;
              for (int i = 0; i < bw; ++i) {
                if (coding.reversible) {
                  dst[i] = src[i] / 2;
                } else {
                  float f = (float)src[i] * half_step;
                  memcpy(dst + i, &f, 4);
                }
              }
            }
          }
        }
      }
      row += (int64_t)cs.comps.size();
    }
    return 0;
  } catch (const Fail& f) {
    info[12] = f.at;
    return f.code;
  } catch (...) {
    return E_DAMAGED;
  }
}

extern "C" int j2k_components(const uint8_t* data, int64_t len, int32_t* out,
                              int n) {
  if (len < 42 || u16(data) != 0xFF4F || u16(data + 2) != 0xFF51)
    return E_NOT_J2K;
  int lsiz = u16(data + 4);
  int ncomp = u16(data + 40);
  if (ncomp != n || lsiz < 38 + 3 * ncomp || 4 + lsiz > len) return E_DAMAGED;
  for (int c = 0; c < n; ++c) {
    const uint8_t* s = data + 42 + 3 * c;
    out[4 * c] = (s[0] & 0x7F) + 1;
    out[4 * c + 1] = (s[0] & 0x80) ? 1 : 0;
    out[4 * c + 2] = s[1];
    out[4 * c + 3] = s[2];
  }
  return 0;
}
