// Native data-pipeline kernels for the hoig_torch input pipeline (a copy of
// hoig_tpu/runtime/warp.cc: the port imports nothing of hoig_tpu).
//
// The reference's data layer leans on torch's C++ DataLoader workers plus
// cv2.warpAffine for the bbox->patch crop (HOIG_HOv3/data/hov3_dataset.py:
// 62-90) executed per sample per step. These are the equivalents, exposed
// through a plain C ABI consumed via ctypes (no pybind11 in this image):
//
//   hoig_warp_affine_u8 : uint8 HxWxC -> float32 OHxOWxC bilinear inverse-
//                         affine warp, cv2.warpAffine(INTER_LINEAR)
//                         semantics (dst->src mapping via the inverted
//                         2x3 matrix, zero border).
//   hoig_normalize_chw  : fused HWC->CHW transpose + scale/offset
//                         (ToTensor + Normalize(0.5, 0.5) + BGR->RGB).
//
// Build: g++ -O3 -march=native -shared -fPIC warp.cc -o libhoigwarp.so
// (driven by hoig_torch/runtime/__init__.py at first use).

#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

// Invert a 2x3 affine matrix (like cv2.invertAffineTransform).
static void invert_affine(const float m[6], float inv[6]) {
  const double a = m[0], b = m[1], c = m[2];
  const double d = m[3], e = m[4], f = m[5];
  double det = a * e - b * d;
  if (det == 0.0) det = 1e-12;
  const double ia = e / det, ib = -b / det;
  const double id = -d / det, ie = a / det;
  inv[0] = (float)ia;
  inv[1] = (float)ib;
  inv[2] = (float)(-(ia * c + ib * f));
  inv[3] = (float)id;
  inv[4] = (float)ie;
  inv[5] = (float)(-(id * c + ie * f));
}

// Bilinear warp: src (h, w, ch) uint8, trans is the FORWARD 2x3 affine
// (src -> dst, the gen_trans_from_patch_cv output); output (oh, ow, ch)
// float32 in [0, 255]. Out-of-range samples are zero (cv2 BORDER_CONSTANT).
void hoig_warp_affine_u8(const uint8_t* src, int h, int w, int ch,
                         const float* trans, int oh, int ow, float* out) {
  float inv[6];
  invert_affine(trans, inv);
  for (int y = 0; y < oh; ++y) {
    const float sy_base_x = inv[1] * (float)y + inv[2];
    const float sy_base_y = inv[4] * (float)y + inv[5];
    float* orow = out + (size_t)y * ow * ch;
    for (int x = 0; x < ow; ++x) {
      const float sx = inv[0] * (float)x + sy_base_x;
      const float sy = inv[3] * (float)x + sy_base_y;
      const int x0 = (int)std::floor(sx);
      const int y0 = (int)std::floor(sy);
      const float tx = sx - (float)x0;
      const float ty = sy - (float)y0;
      float* opix = orow + (size_t)x * ch;
      if (x0 < -1 || y0 < -1 || x0 >= w || y0 >= h) {
        for (int k = 0; k < ch; ++k) opix[k] = 0.0f;
        continue;
      }
      const float w00 = (1 - tx) * (1 - ty);
      const float w01 = tx * (1 - ty);
      const float w10 = (1 - tx) * ty;
      const float w11 = tx * ty;
      const bool in00 = x0 >= 0 && y0 >= 0;
      const bool in01 = x0 + 1 < w && y0 >= 0;
      const bool in10 = x0 >= 0 && y0 + 1 < h;
      const bool in11 = x0 + 1 < w && y0 + 1 < h;
      const uint8_t* p00 = src + ((size_t)y0 * w + x0) * ch;
      const uint8_t* p01 = p00 + ch;
      const uint8_t* p10 = p00 + (size_t)w * ch;
      const uint8_t* p11 = p10 + ch;
      for (int k = 0; k < ch; ++k) {
        float acc = 0.0f;
        if (in00) acc += w00 * (float)p00[k];
        if (in01) acc += w01 * (float)p01[k];
        if (in10) acc += w10 * (float)p10[k];
        if (in11) acc += w11 * (float)p11[k];
        opix[k] = acc;
      }
    }
  }
}

// Fused HWC float32 [0,255] -> CHW float32 normalized:
//   out[c] = (in[..,maybe_swapped_c] / 255) * scale + offset
// swap_rb reverses the channel order (the datasets read BGR via cv2 and
// flip to RGB, hov3_dataset.py:232).
void hoig_normalize_chw(const float* src, int h, int w, int ch, int swap_rb,
                        float scale, float offset, float* out) {
  for (int c = 0; c < ch; ++c) {
    const int sc = swap_rb ? (ch - 1 - c) : c;
    float* oplane = out + (size_t)c * h * w;
    const float* sbase = src + sc;
    for (int i = 0; i < h * w; ++i) {
      oplane[i] = sbase[(size_t)i * ch] * (1.0f / 255.0f) * scale + offset;
    }
  }
}

}  // extern "C"
