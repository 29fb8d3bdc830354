// CIELab (8 bits a channel, L 0..255 for 0..100, a and b offset by 128)
// to sRGB, as Pillow's convert("RGB") of a LAB image computes it: a
// LittleCMS 2.17 transform from cmsCreateLab2Profile(NULL) to
// cmsCreate_sRGBProfile() at TYPE_Lab_8 -> TYPE_RGB_8, perceptual intent,
// no flags. The arithmetic is LittleCMS's own, stage by stage, with its
// float and double types at each step (this source is built without FMA
// contraction, so every product rounds as it does there):
//
// - the pipeline the transform links, once PreOptimize has simplified it:
//   the Lab v2 profile's AToB0 is an identity CLUT whose stage implements
//   cmsSigIdentityElemType, so it goes, and the V4 -> V2 and V2 -> V4
//   stages _cmsReadDevicelinkLUT put around it then meet and go too. What
//   is left is Lab -> XYZ (V4 Lab from floats 0..1, D50, XYZ over
//   1 + 32767/32768), the sRGB profile's inverse RGB -> XYZ matrix times
//   1 + 32767/32768 (its colorants from the Rec. 709 primaries and D65,
//   Bradford-adapted to D50, kept as doubles in the built-in profile), and
//   the inverse of its parametric type 4 curve evaluated analytically
//   (cmsReverseToneCurve gives type -4); floats between stages, doubles
//   inside them. No other stage changes a value: this pipeline gives
//   LittleCMS's unoptimized 16-bit transform at every grid node and at
//   random 16-bit inputs (tests/test_torch_codec_lab.py);
// - the optimization an 8-bit Lab input gets: that pipeline sampled in
//   floating point on a 33-node grid an axis (XFormSampler16: 16-bit nodes
//   to float, the result rounded to 16 bits by _cmsQuickSaturateWord with
//   its 2^-16 fast floor); Lab's white (0xFFFF, 0x8080, 0x8080) is on no
//   node of that grid, so the white fix-up patches nothing;
// - each pixel: its bytes widened to 16 bits (x * 257), 16-bit tetrahedral
//   interpolation in the grid (TetrahedralInterp16's fixed point), and the
//   16 -> 8 bit rounding of LittleCMS's packers ((x * 65281 + 2^23) >> 24).
//
// The grid is built once a process, at first use, from this arithmetic; no
// table of LittleCMS's is stored.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <mutex>

namespace {

constexpr int kGrid = 33;  // _cmsReasonableGridpointsByColorspace for 3 channels
constexpr double kMaxEncodeableXYZ = 1.0 + 32767.0 / 32768.0;
constexpr double kD50X = 0.9642, kD50Y = 1.0, kD50Z = 0.8249;

// _cmsQuickFloor: floor after rounding to a multiple of 2^-16 (the low
// word of val + 1.5 * 2^36, shifted)
int quick_floor(double val) {
  double magic = val + 68719476736.0 * 1.5;
  uint64_t bits;
  std::memcpy(&bits, &magic, sizeof bits);
  return int32_t(uint32_t(bits)) >> 16;
}

uint16_t quick_saturate_word(double d) {
  d += 0.5;
  if (d <= 0) return 0;
  if (d >= 65535.0) return 0xffff;
  return uint16_t(uint16_t(quick_floor(d - 32767.0)) + 32767);
}

struct Mat3 {
  double v[3][3];
};

Mat3 mat_mul(const Mat3& a, const Mat3& b) {  // _cmsMAT3per
  Mat3 r;
  for (int i = 0; i < 3; i++)
    for (int j = 0; j < 3; j++)
      r.v[i][j] = a.v[i][0] * b.v[0][j] + a.v[i][1] * b.v[1][j] + a.v[i][2] * b.v[2][j];
  return r;
}

void mat_eval(double r[3], const Mat3& a, const double v[3]) {  // _cmsMAT3eval
  for (int i = 0; i < 3; i++) r[i] = a.v[i][0] * v[0] + a.v[i][1] * v[1] + a.v[i][2] * v[2];
}

Mat3 mat_inverse(const Mat3& a) {  // _cmsMAT3inverse
  const double(*m)[3] = a.v;
  double c0 = m[1][1] * m[2][2] - m[1][2] * m[2][1];
  double c1 = -m[1][0] * m[2][2] + m[1][2] * m[2][0];
  double c2 = m[1][0] * m[2][1] - m[1][1] * m[2][0];
  double det = m[0][0] * c0 + m[0][1] * c1 + m[0][2] * c2;
  Mat3 b;
  b.v[0][0] = c0 / det;
  b.v[0][1] = (m[0][2] * m[2][1] - m[0][1] * m[2][2]) / det;
  b.v[0][2] = (m[0][1] * m[1][2] - m[0][2] * m[1][1]) / det;
  b.v[1][0] = c1 / det;
  b.v[1][1] = (m[0][0] * m[2][2] - m[0][2] * m[2][0]) / det;
  b.v[1][2] = (m[0][2] * m[1][0] - m[0][0] * m[1][2]) / det;
  b.v[2][0] = c2 / det;
  b.v[2][1] = (m[0][1] * m[2][0] - m[0][0] * m[2][1]) / det;
  b.v[2][2] = (m[0][0] * m[1][1] - m[0][1] * m[1][0]) / det;
  return b;
}

void xyY_to_XYZ(double out[3], double x, double y, double Y) {  // cmsxyY2XYZ
  out[0] = (x / y) * Y;
  out[1] = Y;
  out[2] = ((1 - x - y) / y) * Y;
}

// _cmsAdaptationMatrix with the Bradford cone matrix (ComputeChromaticAdaptation)
Mat3 bradford(const double from[3], const double to[3]) {
  const Mat3 chad = {{{0.8951, 0.2664, -0.1614}, {-0.7502, 1.7135, 0.0367},
                      {0.0389, -0.0685, 1.0296}}};
  Mat3 chad_inv = mat_inverse(chad);
  double src[3], dst[3];
  mat_eval(src, chad, from);
  mat_eval(dst, chad, to);
  Mat3 cone = {{{dst[0] / src[0], 0.0, 0.0}, {0.0, dst[1] / src[1], 0.0},
                {0.0, 0.0, dst[2] / src[2]}}};
  return mat_mul(chad_inv, mat_mul(cone, chad));
}

// cmsCreate_sRGBProfile's colorants: _cmsBuildRGB2XYZtransferMatrix of the
// Rec. 709 primaries and D65 (x 0.3127, y 0.3290), adapted to D50
Mat3 srgb_rgb_to_xyz() {
  const double xn = 0.3127, yn = 0.3290;
  const double xr = 0.64, yr = 0.33, xg = 0.30, yg = 0.60, xb = 0.15, yb = 0.06;
  Mat3 prim = {{{xr, xg, xb}, {yr, yg, yb}, {(1 - xr - yr), (1 - xg - yg), (1 - xb - yb)}}};
  Mat3 inv = mat_inverse(prim);
  double white[3] = {xn / yn, 1.0, (1.0 - xn - yn) / yn}, coef[3];
  mat_eval(coef, inv, white);
  Mat3 r = {{{coef[0] * xr, coef[1] * xg, coef[2] * xb},
             {coef[0] * yr, coef[1] * yg, coef[2] * yb},
             {coef[0] * (1.0 - xr - yr), coef[1] * (1.0 - xg - yg), coef[2] * (1.0 - xb - yb)}}};
  double d65[3], d50[3] = {kD50X, kD50Y, kD50Z};
  xyY_to_XYZ(d65, xn, yn, 1.0);
  return mat_mul(bradford(d65, d50), r);  // cmsAdaptMatrixToD50
}

// the inverse of the sRGB parametric curve (type -4), DefaultEvalParametricFn
double srgb_inverse_curve(double R) {
  const double p[5] = {2.4, 1. / 1.055, 0.055 / 1.055, 1. / 12.92, 0.04045};
  double e = p[1] * p[4] + p[2];
  double disc = e < 0 ? 0 : pow(e, p[0]);
  if (R >= disc) return (pow(R, 1.0 / p[0]) - p[2]) / p[1];
  return R / p[3];
}

double lab_f_inverse(double t) {  // cmsLab2XYZ's f_1
  const double limit = 24.0 / 116.0;
  if (t <= limit) return (108.0 / 841.0) * (t - (16.0 / 116.0));
  return t * t * t;
}

// the linked pipeline in floating point, as cmsPipelineEvalFloat runs it
void eval_float(const double out_matrix[9], const float in[3], float out[3]) {
  float a[3], b[3];
  {  // EvaluateLab2XYZ
    double L = double(in[0]) * 100.0, la = double(in[1]) * 255.0 - 128.0,
           lb = double(in[2]) * 255.0 - 128.0;
    double y = (L + 16.0) / 116.0, x = y + 0.002 * la, z = y - 0.005 * lb;
    double X = lab_f_inverse(x) * kD50X, Y = lab_f_inverse(y) * kD50Y,
           Z = lab_f_inverse(z) * kD50Z;
    b[0] = float(X / kMaxEncodeableXYZ);
    b[1] = float(Y / kMaxEncodeableXYZ);
    b[2] = float(Z / kMaxEncodeableXYZ);
  }
  for (int i = 0; i < 3; i++) {  // EvaluateMatrix
    double t = 0;
    for (int j = 0; j < 3; j++) t += double(b[j]) * out_matrix[i * 3 + j];
    a[i] = float(t);
  }
  for (int i = 0; i < 3; i++) out[i] = float(srgb_inverse_curve(double(a[i])));
}

// BuildRGBOutputMatrixShaper's matrix: the colorants inverted, times the
// XYZ encoding
void output_matrix(double out[9]) {
  Mat3 inv = mat_inverse(srgb_rgb_to_xyz());
  for (int i = 0; i < 9; i++) out[i] = inv.v[i / 3][i % 3] * kMaxEncodeableXYZ;
}

uint16_t quantize_node(int i) {  // _cmsQuantizeVal
  return quick_saturate_word(double(i) * 65535. / double(kGrid - 1));
}

void sample(const double m[9], const uint16_t in[3], uint16_t out[3]) {  // XFormSampler16
  float fi[3], fo[3];
  for (int i = 0; i < 3; i++) fi[i] = float(in[i] / 65535.0);
  eval_float(m, fi, fo);
  for (int i = 0; i < 3; i++) out[i] = quick_saturate_word(double(fo[i]) * 65535.0);
}

uint16_t g_grid[kGrid * kGrid * kGrid * 3];
std::once_flag g_once;

void build_grid() {
  double m[9];
  output_matrix(m);
  int k = 0;
  for (int x = 0; x < kGrid; x++)
    for (int y = 0; y < kGrid; y++)
      for (int z = 0; z < kGrid; z++, k += 3) {
        uint16_t in[3] = {quantize_node(x), quantize_node(y), quantize_node(z)};
        sample(m, in, &g_grid[k]);
      }
}

// TetrahedralInterp16 on the grid
void tetrahedral(const uint16_t in[3], uint16_t out[3]) {
  const int domain = kGrid - 1, opta0 = 3, opta1 = 3 * kGrid, opta2 = 3 * kGrid * kGrid;
  auto fixed = [](int a) { return a + ((a + 0x7fff) / 0xffff); };  // _cmsToFixedDomain
  int fx = fixed(int(in[0]) * domain), fy = fixed(int(in[1]) * domain),
      fz = fixed(int(in[2]) * domain);
  int x0 = fx >> 16, y0 = fy >> 16, z0 = fz >> 16;
  int rx = fx & 0xffff, ry = fy & 0xffff, rz = fz & 0xffff;
  int X0 = opta2 * x0, X1 = in[0] == 0xffff ? 0 : opta2;
  int Y0 = opta1 * y0, Y1 = in[1] == 0xffff ? 0 : opta1;
  int Z0 = opta0 * z0, Z1 = in[2] == 0xffff ? 0 : opta0;
  const uint16_t* t = g_grid + X0 + Y0 + Z0;
  for (int o = 0; o < 3; o++, t++) {
    int c0 = t[0], c1, c2, c3;
    if (rx >= ry) {
      if (ry >= rz) {  // x >= y >= z
        int a = X1, b = X1 + Y1, c = X1 + Y1 + Z1;
        c1 = t[a] - c0;
        c2 = t[b] - t[a];
        c3 = t[c] - t[b];
      } else if (rz >= rx) {  // z >= x >= y
        int a = Z1 + X1, b = Z1 + X1 + Y1, c = Z1;
        c1 = t[a] - t[c];
        c2 = t[b] - t[a];
        c3 = t[c] - c0;
      } else {  // x > z > y
        int a = X1, b = X1 + Z1 + Y1, c = X1 + Z1;
        c1 = t[a] - c0;
        c2 = t[b] - t[c];
        c3 = t[c] - t[a];
      }
    } else {
      if (rx >= rz) {  // y > x >= z
        int a = Y1 + X1, b = Y1, c = Y1 + X1 + Z1;
        c1 = t[a] - t[b];
        c2 = t[b] - c0;
        c3 = t[c] - t[a];
      } else if (ry >= rz) {  // y >= z > x
        int a = Y1 + Z1 + X1, b = Y1, c = Y1 + Z1;
        c1 = t[a] - t[c];
        c2 = t[b] - c0;
        c3 = t[c] - t[b];
      } else {  // z > y > x
        int a = Z1 + Y1 + X1, b = Z1 + Y1, c = Z1;
        c1 = t[a] - t[b];
        c2 = t[b] - t[c];
        c3 = t[c] - c0;
      }
    }
    // int arithmetic as LittleCMS's build does it: wrapping at 32 bits
    int32_t rest = int32_t(uint32_t(c1) * uint32_t(rx) + uint32_t(c2) * uint32_t(ry) +
                           uint32_t(c3) * uint32_t(rz) + 0x8001u);
    out[o] = uint16_t(c0 + ((int32_t(uint32_t(rest) + uint32_t(rest >> 16))) >> 16));
  }
}

}  // namespace

extern "C" {

// n pixels of TYPE_Lab_8 (L, a + 128, b + 128) -> RGB
void qie_lab_srgb(const uint8_t* lab, long n, uint8_t* rgb) {
  std::call_once(g_once, build_grid);
  for (long i = 0; i < n; i++, lab += 3, rgb += 3) {
    uint16_t in[3], out[3];
    for (int c = 0; c < 3; c++) in[c] = uint16_t(lab[c] * 257);  // FROM_8_TO_16
    tetrahedral(in, out);
    for (int c = 0; c < 3; c++) rgb[c] = uint8_t((uint32_t(out[c]) * 65281u + 8388608u) >> 24);
  }
}

// the sampled grid (kGrid^3 nodes of 3 values, the last input fastest)
long qie_lab_srgb_grid(uint16_t* out) {
  std::call_once(g_once, build_grid);
  for (long i = 0; i < long(sizeof(g_grid) / sizeof(g_grid[0])); i++) out[i] = g_grid[i];
  return kGrid;
}

// the unoptimized pipeline at n 16-bit inputs, as a 16-bit transform runs it
void qie_lab_srgb_eval16(const uint16_t* in, long n, uint16_t* out) {
  double m[9];
  output_matrix(m);
  for (long i = 0; i < n; i++, in += 3, out += 3) {
    float fi[3], fo[3];
    for (int c = 0; c < 3; c++) fi[c] = float(in[c]) / 65535.0F;  // _LUTeval16
    eval_float(m, fi, fo);
    for (int c = 0; c < 3; c++) out[c] = quick_saturate_word(double(fo[c]) * 65535.0);
  }
}

// the sRGB profile's colorant matrix (RGB -> XYZ, D50), row major
void qie_lab_srgb_colorants(double* out) {
  Mat3 m = srgb_rgb_to_xyz();
  for (int i = 0; i < 9; i++) out[i] = m.v[i / 3][i % 3];
}

}  // extern "C"
