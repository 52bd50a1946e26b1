// Host-side negacyclic products of rustfhe_tpu_torch (native.py).
//
// The port's own copy of the JAX package's host library: fast host-side
// negacyclic polynomial arithmetic, the role the reference's C++/asm
// spqlios stack plays behind its Rust FFI.  Host code, not a device kernel:
// no CUDA path calls it.
//   * an exact O(N^2) uint32 negacyclic convolution (an oracle independent
//     of the torch and numpy products),
//   * a radix-2 f64 negacyclic FFT multiply (approximate, host-only), on the
//     psi-twist + cyclic FFT factorization of X^N + 1.
//
// Built with the host C++ compiler (native.py: -O3 -march=native -std=c++17
// -fPIC -shared) and bound through ctypes.  The circuit levelizer of the JAX
// library is not here: the port levelizes with its numpy loop.

#include <cmath>
#include <complex>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

using cplx = std::complex<double>;

// Iterative radix-2 Cooley-Tukey, in-place, n a power of two.
void fft_inplace(cplx* a, std::size_t n, bool inverse) {
  // bit-reversal permutation
  for (std::size_t i = 1, j = 0; i < n; ++i) {
    std::size_t bit = n >> 1;
    for (; j & bit; bit >>= 1) j ^= bit;
    j ^= bit;
    if (i < j) std::swap(a[i], a[j]);
  }
  for (std::size_t len = 2; len <= n; len <<= 1) {
    const double ang = (inverse ? 2.0 : -2.0) * M_PI / static_cast<double>(len);
    const cplx wlen(std::cos(ang), std::sin(ang));
    for (std::size_t i = 0; i < n; i += len) {
      cplx w(1.0, 0.0);
      for (std::size_t k = 0; k < len / 2; ++k) {
        const cplx u = a[i + k];
        const cplx v = a[i + k + len / 2] * w;
        a[i + k] = u + v;
        a[i + k + len / 2] = u - v;
        w *= wlen;
      }
    }
  }
  if (inverse) {
    const double inv = 1.0 / static_cast<double>(n);
    for (std::size_t i = 0; i < n; ++i) a[i] *= inv;
  }
}

}  // namespace

extern "C" {

// Exact negacyclic convolution mod 2^32: out = a (*) b over Z[X]/(X^N+1),
// a uint32 torus coefficients, b int32 small coefficients.
void negacyclic_mul_u32_exact(const uint32_t* a, const int32_t* b,
                              uint32_t* out, int64_t n) {
  for (int64_t k = 0; k < n; ++k) {
    uint32_t acc = 0;
    for (int64_t j = 0; j <= k; ++j)
      acc += a[j] * static_cast<uint32_t>(b[k - j]);
    for (int64_t j = k + 1; j < n; ++j)
      acc -= a[j] * static_cast<uint32_t>(b[n + k - j]);
    out[k] = acc;
  }
}

// Approximate negacyclic product of f64 polynomials via the psi-twisted FFT:
// c_k = psi^-k * IFFT( FFT(psi^j a_j) . FFT(psi^j b_j) )_k, psi = e^{i pi/N}.
// Returns 0 on success, -1 if n is not a power of two >= 2.
int negacyclic_mul_f64_fft(const double* a, const double* b, double* out,
                           int64_t n) {
  if (n < 2 || (n & (n - 1)) != 0) return -1;
  std::vector<cplx> fa(n), fb(n);
  const double step = M_PI / static_cast<double>(n);
  for (int64_t j = 0; j < n; ++j) {
    const cplx psi(std::cos(step * j), std::sin(step * j));
    fa[j] = psi * a[j];
    fb[j] = psi * b[j];
  }
  fft_inplace(fa.data(), n, false);
  fft_inplace(fb.data(), n, false);
  for (int64_t j = 0; j < n; ++j) fa[j] *= fb[j];
  fft_inplace(fa.data(), n, true);
  for (int64_t k = 0; k < n; ++k) {
    const cplx unpsi(std::cos(step * k), -std::sin(step * k));
    out[k] = (fa[k] * unpsi).real();
  }
  return 0;
}

// Torus variant mirroring the reference's usage (Torus32 x int -> Torus32
// through the float domain, fft_processor_spqlios.cpp:156-183 semantics):
// inputs are u32 torus values and small ints; output is rounded back mod 2^32.
int negacyclic_mul_torus_fft(const uint32_t* a, const int32_t* b,
                             uint32_t* out, int64_t n) {
  std::vector<double> fa(n), fb(n), fo(n);
  for (int64_t i = 0; i < n; ++i) {
    // centered lift keeps magnitudes ~2^31 -> f64 exact (53-bit mantissa)
    fa[i] = static_cast<double>(static_cast<int32_t>(a[i]));
    fb[i] = static_cast<double>(b[i]);
  }
  const int rc = negacyclic_mul_f64_fft(fa.data(), fb.data(), fo.data(), n);
  if (rc != 0) return rc;
  for (int64_t i = 0; i < n; ++i) {
    out[i] = static_cast<uint32_t>(static_cast<int64_t>(std::llround(fo[i])));
  }
  return 0;
}

}  // extern "C"
