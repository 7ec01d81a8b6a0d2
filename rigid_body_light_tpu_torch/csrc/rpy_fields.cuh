// RPY + Swan–Brady wall pair fields shared by the pair-sweep kernels
// (rpy_pair_sweep.cu: K1, K2; near_sweep.cu: K3), float32, and the
// pseudo-2D box's wrap and image lattice (K1 and K2's box forms).
//
// They compute what the shared field helpers of the Pallas kernels do
// (rigid_body_light_tpu/ops/rpy_pallas.py: _mono_coeffs, _poly_coeffs,
// _wall_coeffs), so the three CUDA kernels cannot drift apart either.
//
// Numerics: IEEE division and sqrt (no --use_fast_math, no __fdividef —
// approximate reciprocals floor GMRES convergence, rpy_pallas.py:22-26).
// 1/r and 1/R use rsqrtf (≤ 2 ulp), as the Pallas kernels use lax.rsqrt.
// r² and R² are floored at 1e-24 and the image height sum at 1e-12 in the
// h/(z_i+z_j) division.  Callers mask a pair with a select, never a
// multiply by a mask (the unselected value may hold inf/NaN).
//
// Work per pair, kept small because every pair of K1–K3 pays it:
//   - heights arrive already floored (floor_height, once per blob; the
//     polydisperse fields floor per pair, pair_fields_poly);
//   - dx² + dy² is shared by r² and the image distance R²;
//   - the near/far select is taken on α and β only;
//   - each wall field is a polynomial in s = 1/R² (Horner) whose
//     coefficients are linear in ez², the 1/3 multiples folded into them;
//   - the identity coefficient α + f1 and the ẑẑ coefficient α + f1 + f5
//     are summed once per pair, so an apply makes 19 operations.

#pragma once

#include <cuda_runtime.h>

namespace rpy_fields {

constexpr float kR2Floor = 1e-24f;

// M = aI·I + b·d dᵀ + f2·e eᵀ + f3·e ẑᵀ + f4·ẑ eᵀ + (aZ − aI)·ẑ ẑᵀ, i.e.
// α I + β d dᵀ plus the wall block C = f1 I + f2 e eᵀ + f3 e ẑᵀ + f4 ẑ eᵀ
// + f5 ẑ ẑᵀ with aI = α + f1, aZ = α + f1 + f5.  Free space: aI = α, b = β.
struct Fields {
  float aI, aZ, b;
  float ex, ey, ez;                // wall image direction e
  float f2, f3, f4;
};

// A blob's height as the wall fields see it (units of a): floored at
// h_floor when the floor is on.  Depends on one blob only.
__device__ __forceinline__ float floor_height(float z, float h_floor) {
  return h_floor > 0.0f ? fmaxf(z, h_floor) : z;
}

// Pair fields at displacement d = r_i − r_j (units of a); zRw, zCw the
// floored row and column heights (floor_height).
template <bool WALL>
__device__ __forceinline__ Fields pair_fields(float dx, float dy, float dz,
                                              float zRw, float zCw) {
  Fields p;
  const float rho2 = fmaf(dx, dx, dy * dy);
  const float r2 = fmaxf(fmaf(dz, dz, rho2), kR2Floor);
  const float invr = rsqrtf(r2);
  const float invr2 = invr * invr;
  const float r = r2 * invr;
  const bool far = r >= 2.0f;
  // far: α = (1 + 2/(3r²))/r, β = (1 − 2/r²)/r³;
  // overlapping: α = 4/3·(1 − 9r/32), β = 4/3·3/(32r)
  const float alpha = far ? invr * fmaf(2.0f / 3.0f, invr2, 1.0f)
                          : fmaf(-0.375f, r, 4.0f / 3.0f);
  p.b = far ? (invr2 * invr) * fmaf(-2.0f, invr2, 1.0f) : 0.125f * invr;
  p.aI = p.aZ = alpha;
  if (WALL) {
    const float zs = zRw + zCw;
    const float R2 = fmaxf(fmaf(zs, zs, rho2), kR2Floor);
    const float invR = rsqrtf(R2);
    const float s = invR * invR;
    p.ex = dx * invR;
    p.ey = dy * invR;
    p.ez = zs * invR;
    const float u = p.ez * p.ez;
    const float h = zCw / fmaxf(zs, 1e-12f);    // ĥ = z_j / (z_i + z_j)
    const float h2 = h + h;
    const float hh2 = 2.0f * fmaf(-h, h, h);    // 2ĥ(1 − ĥ)
    const float ezR = p.ez * invR;
    // f1 = −[3(1 + 2ĥ(1−ĥ)u)/R + 2(1 − 3u)/R³ − 2(1 − 5u)/R⁵]/3
    const float f1 = -invR * fmaf(s, fmaf(s, fmaf(10.0f / 3.0f, u, -2.0f / 3.0f),
                                          fmaf(-2.0f, u, 2.0f / 3.0f)),
                                  fmaf(hh2, u, 1.0f));
    // f2 = −[3(1 − 6ĥ(1−ĥ)u)/R − 6(1 − 5u)/R³ + 10(1 − 7u)/R⁵]/3
    p.f2 = -invR * fmaf(s, fmaf(s, fmaf(-70.0f / 3.0f, u, 10.0f / 3.0f),
                                fmaf(10.0f, u, -2.0f)),
                        fmaf(-3.0f * hh2, u, 1.0f));
    // f3 = 2ez/3·[3ĥ(1 − 6(1−ĥ)u)/R − 6(1 − 5u)/R³ + 10(2 − 7u)/R⁵]
    p.f3 = ezR * fmaf(s, fmaf(s, fmaf(-140.0f / 3.0f, u, 40.0f / 3.0f),
                              fmaf(20.0f, u, -4.0f)),
                      fmaf(-6.0f * hh2, u, h2));
    // f4 = 2ez/3·[3ĥ/R − 10/R⁵]
    p.f4 = ezR * fmaf(-20.0f / 3.0f, s * s, h2);
    // f5 = −4/3·[3ĥ²u/R + 3u/R³ + (2 − 15u)/R⁵]
    const float f5 = -invR * fmaf(s, fmaf(s, fmaf(-20.0f, u, 8.0f / 3.0f),
                                          4.0f * u),
                                  4.0f * (h * h) * u);
    p.aI = alpha + f1;
    p.aZ = p.aI + f5;
  }
  return p;
}

// The polydisperse pair fields (rpy_pallas.py: _poly_coeffs, _wall_coeffs
// with poly), K1's and K2's POLY forms.  aR, aC are the blobs' radii in
// units of a, zR, zC their raw heights: the wall fields are evaluated in
// units of the pair's √(aR·aC), so a height is scaled by inv_ae =
// 1/√(aR·aC) and floored per pair, after the scaling (the monodisperse
// fields get heights floored once per blob).  Free-space branches (Zuk et
// al. 2014):
//   r ≥ aR + aC          α = (1 + (aR² + aC²)/(3r²))/r, β = (1 − (aR² + aC²)/r²)/r³
//   |aR − aC| ≤ r < aR + aC   α = p·g_I, β = p·g_e/r², p = (4/3)/(aR·aC),
//                        g_I = (16r³(aR + aC) − ((aR − aC)² + 3r²)²)/(32r³),
//                        g_e = 3((aR − aC)² − r²)²/(32r³)
//   r < |aR − aC|        α = (4/3)/max(aR, aC), β = 0
// p and the deep α are IEEE divisions.  The wall image direction is
// e = (dx·inv_ae, dy·inv_ae, zs)/R with zs the floored scaled height sum
// and R² = ρ²·inv_ae² + zs², and f1–f5 are the equal-radius fields there
// times inv_ae: their common factor 1/R becomes q = inv_ae/R, which also
// scales ex, ey.  Every quantity is symmetric under R ↔ C except ĥ, as in
// the monodisperse fields, so apply<WALL, true> stays the transpose.
template <bool WALL>
__device__ __forceinline__ Fields pair_fields_poly(float dx, float dy,
                                                   float dz, float zR,
                                                   float zC, float aR,
                                                   float aC, float h_floor) {
  Fields p;
  const float rho2 = fmaf(dx, dx, dy * dy);
  const float r2 = fmaxf(fmaf(dz, dz, rho2), kR2Floor);
  const float invr = rsqrtf(r2);
  const float invr2 = invr * invr;
  const float r = r2 * invr;
  const float a2s = fmaf(aR, aR, aC * aC);
  const float asum = aR + aC;
  const float adiff = aR - aC;
  float alpha, beta;
  if (r >= asum) {
    alpha = invr * fmaf(a2s * (1.0f / 3.0f), invr2, 1.0f);
    beta = (invr2 * invr) * fmaf(-a2s, invr2, 1.0f);
  } else if (r < fabsf(adiff)) {
    alpha = (4.0f / 3.0f) / fmaxf(fmaxf(aR, aC), kR2Floor);
    beta = 0.0f;
  } else {
    const float pref = (4.0f / 3.0f) / fmaxf(aR * aC, kR2Floor);
    const float invr3_32 = invr * invr2 * (1.0f / 32.0f);
    const float ad2 = adiff * adiff;
    const float t = fmaf(3.0f, r2, ad2);
    const float g_i = fmaf(16.0f * r2 * r, asum, -t * t) * invr3_32;
    const float v = ad2 - r2;
    const float g_e = 3.0f * v * v * invr3_32;
    alpha = pref * g_i;
    beta = pref * g_e * invr2;
  }
  p.b = beta;
  p.aI = p.aZ = alpha;
  if (WALL) {
    const float inv_ae = rsqrtf(fmaxf(aR * aC, kR2Floor));
    const float zRw = floor_height(zR * inv_ae, h_floor);
    const float zCw = floor_height(zC * inv_ae, h_floor);
    const float zs = zRw + zCw;
    const float R2 = fmaxf(fmaf(zs, zs, rho2 * (inv_ae * inv_ae)), kR2Floor);
    const float invR = rsqrtf(R2);
    const float s = invR * invR;
    const float q = inv_ae * invR;               // 1/R, scaled back by inv_ae
    p.ex = dx * q;
    p.ey = dy * q;
    p.ez = zs * invR;
    const float u = p.ez * p.ez;
    const float h = zCw / fmaxf(zs, 1e-12f);
    const float h2 = h + h;
    const float hh2 = 2.0f * fmaf(-h, h, h);
    const float ezq = p.ez * q;
    const float f1 = -q * fmaf(s, fmaf(s, fmaf(10.0f / 3.0f, u, -2.0f / 3.0f),
                                       fmaf(-2.0f, u, 2.0f / 3.0f)),
                               fmaf(hh2, u, 1.0f));
    p.f2 = -q * fmaf(s, fmaf(s, fmaf(-70.0f / 3.0f, u, 10.0f / 3.0f),
                             fmaf(10.0f, u, -2.0f)),
                     fmaf(-3.0f * hh2, u, 1.0f));
    p.f3 = ezq * fmaf(s, fmaf(s, fmaf(-140.0f / 3.0f, u, 40.0f / 3.0f),
                              fmaf(20.0f, u, -4.0f)),
                      fmaf(-6.0f * hh2, u, h2));
    p.f4 = ezq * fmaf(-20.0f / 3.0f, s * s, h2);
    const float f5 = -q * fmaf(s, fmaf(s, fmaf(-20.0f, u, 8.0f / 3.0f),
                                       4.0f * u),
                               4.0f * (h * h) * u);
    p.aI = alpha + f1;
    p.aZ = p.aI + f5;
  }
  return p;
}

// M_ij·F (forward).  With TRANSPOSE, M_ijᵀ·F = M_ji·F: the free block is
// symmetric and the wall block swaps the roles of f3 and f4
// (rpy_pallas.py:421-424 vs :443-446).
template <bool WALL, bool TRANSPOSE>
__device__ __forceinline__ void apply(const Fields& p, float dx, float dy,
                                      float dz, float fx, float fy, float fz,
                                      float& ux, float& uy, float& uz) {
  const float bdF = p.b * fmaf(dz, fz, fmaf(dy, fy, dx * fx));
  if (WALL) {
    const float eF = fmaf(p.ez, fz, fmaf(p.ey, fy, p.ex * fx));
    const float fa = TRANSPOSE ? p.f4 : p.f3;   // multiplies fz·e
    const float fb = TRANSPOSE ? p.f3 : p.f4;   // multiplies eF·ẑ
    const float g = fmaf(p.f2, eF, fa * fz);
    ux = fmaf(p.aI, fx, fmaf(bdF, dx, g * p.ex));
    uy = fmaf(p.aI, fy, fmaf(bdF, dy, g * p.ey));
    uz = fmaf(p.aZ, fz, fmaf(bdF, dz, fmaf(g, p.ez, fb * eF)));
  } else {
    ux = fmaf(p.aI, fx, bdF * dx);
    uy = fmaf(p.aI, fy, bdF * dy);
    uz = fmaf(p.aI, fz, bdF * dz);
  }
}

// The pseudo-2D (Lx, Ly) box of K1's and K2's box forms (units of a), and
// the exact doubly-periodic image sum over the (2S+1)² − 1 nonzero in-plane
// offsets (ix·Lx, iy·Ly) of the wrapped displacement (rpy_pallas.py:369-373,
// :454-476), with the two-ring Richardson tail weights 1 + α on ring S and
// 1 + β on ring S − 1 (rpy.tail_coeffs, computed on the host).
struct Box {
  float lx, ly;        // box lengths
  float ilx, ily;      // their reciprocals
  int shells;          // S; 0 is the minimum image alone
  float w_outer;       // weight on ring S
  float w_inner;       // weight on ring S − 1
};

// Minimum-image wrap of the displacement xi − xj along a box length L:
// xi − xj − n·L with n = round-half-even((xi − xj)/L) of the exact
// difference, the image the plain sweep (rpy._wrap_xy) takes in float64
// from the same float32 inputs, ties at exactly ±L/2 included (they stay,
// as jnp.round leaves them).  The float32 quotient decides unless it lies
// within its rounding error of a half-integer; there the float64 quotient
// of the exact difference does.  Odd in (xi, xj): wrap(xj, xi) =
// −wrap(xi, xj), so the wrapped operator stays symmetric.
__device__ __forceinline__ float wrap(float xi, float xj, float L, float iL) {
  const float d = xi - xj;
  const float q = d * iL;
  float n = rintf(q);
  if (fabsf(fabsf(q - n) - 0.5f) <= 1e-6f * fabsf(q))
    n = static_cast<float>(rint(
        (static_cast<double>(xi) - static_cast<double>(xj)) /
        static_cast<double>(L)));
  return fmaf(-n, L, d);
}

// The fields of one image, weighted: every coefficient of M is linear in
// (aI, aZ, b, f2, f3, f4); e stays a unit vector.
__device__ __forceinline__ void scale(Fields& p, float w) {
  p.aI *= w;
  p.aZ *= w;
  p.b *= w;
  p.f2 *= w;
  p.f3 *= w;
  p.f4 *= w;
}

// The nonzero offsets (ix, iy) of the lattice in the JAX package's order
// (ix major) and their ring's tail weight: fn(ix, iy, w).
template <typename Fn>
__device__ __forceinline__ void for_each_offset(const Box& b, Fn&& fn) {
  const int S = b.shells;
  for (int ix = -S; ix <= S; ++ix)
    for (int iy = -S; iy <= S; ++iy) {
      if (ix == 0 && iy == 0) continue;
      const int ring = max(abs(ix), abs(iy));
      fn(static_cast<float>(ix), static_cast<float>(iy),
         ring == S ? b.w_outer : (ring == S - 1 ? b.w_inner : 1.0f));
    }
}

}  // namespace rpy_fields
