// Native CPU oracle for qtesla_ntt (C ABI, loaded via ctypes).
//
// Plays the role the reference's CPU-side naive transforms play
// (NTT_naive/INTT_naive NTT.cu:515-554, schoolbook base multiply
// NTT.cu:147-165, Z_{2^32-1} macros NTT.cu:102-134): an independent,
// obviously-correct native implementation the JAX/Pallas kernels are
// validated against.  Written fresh: 128-bit accumulation, batch-major
// loops, no CUDA-isms.
//
// Build: make -C csrc   (g++ -O2 -shared -fPIC)

#include <cstddef>
#include <cstdint>

using std::size_t;

extern "C" {

// z = x * y mod (X^n + 1) mod q, one polynomial.
void oracle_negacyclic_schoolbook(const uint32_t* x, const uint32_t* y,
                                  uint32_t* z, uint32_t n, uint32_t q) {
    for (uint32_t k = 0; k < n; ++k) {
        // signed accumulation in 128 bits: |sum| <= n * q^2 < 2^71 for
        // n <= 2^11, q < 2^30 — fits __int128 comfortably.
        __int128 acc = 0;
        for (uint32_t i = 0; i <= k; ++i)
            acc += (__int128)x[i] * y[k - i];
        for (uint32_t i = k + 1; i < n; ++i)
            acc -= (__int128)x[i] * y[n + k - i];
        __int128 r = acc % (__int128)q;
        if (r < 0) r += q;
        z[k] = (uint32_t)r;
    }
}

// Batched wrapper: B polynomials, flat arrays of length B*n.
void oracle_negacyclic_schoolbook_batch(const uint32_t* x, const uint32_t* y,
                                        uint32_t* z, uint32_t batch,
                                        uint32_t n, uint32_t q) {
    for (uint32_t b = 0; b < batch; ++b)
        oracle_negacyclic_schoolbook(x + (size_t)b * n, y + (size_t)b * n,
                                     z + (size_t)b * n, n, q);
}

static uint64_t powmod(uint64_t base, uint64_t exp, uint64_t mod) {
    uint64_t r = 1 % mod;
    base %= mod;
    while (exp) {
        if (exp & 1) r = (uint64_t)((__uint128_t)r * base % mod);
        base = (uint64_t)((__uint128_t)base * base % mod);
        exp >>= 1;
    }
    return r;
}

// X[k] = sum_j x[j] * w^(jk) mod q  (cyclic, natural order both sides).
void oracle_ntt_naive(const uint32_t* x, uint32_t* X, uint32_t n, uint32_t q,
                      uint32_t omega) {
    for (uint32_t k = 0; k < n; ++k) {
        uint64_t wk = powmod(omega, k, q);
        uint64_t acc = 0, pw = 1;
        for (uint32_t j = 0; j < n; ++j) {
            acc = (acc + (uint64_t)((__uint128_t)x[j] * pw % q)) % q;
            pw = (uint64_t)((__uint128_t)pw * wk % q);
        }
        X[k] = (uint32_t)acc;
    }
}

// x[j] = n^{-1} * sum_k X[k] * w^(-jk) mod q.
void oracle_intt_naive(const uint32_t* X, uint32_t* x, uint32_t n, uint32_t q,
                       uint32_t omega) {
    uint32_t omega_inv = (uint32_t)powmod(omega, q - 2, q);
    uint64_t n_inv = powmod(n % q, q - 2, q);
    oracle_ntt_naive(X, x, n, q, omega_inv);
    for (uint32_t j = 0; j < n; ++j)
        x[j] = (uint32_t)((__uint128_t)x[j] * n_inv % q);
}

// Negacyclic product over Z_{2^32-1} (the Nussbaumer ring), canonical
// representatives in [0, 2^32-1).
void oracle_negacyclic_schoolbook_ring(const uint32_t* x, const uint32_t* y,
                                       uint32_t* z, uint32_t n) {
    const uint64_t M = 0xFFFFFFFFull;
    for (uint32_t k = 0; k < n; ++k) {
        __int128 acc = 0;
        for (uint32_t i = 0; i <= k; ++i)
            acc += (__int128)x[i] * y[k - i];
        for (uint32_t i = k + 1; i < n; ++i)
            acc -= (__int128)x[i] * y[n + k - i];
        __int128 r = acc % (__int128)M;
        if (r < 0) r += M;
        z[k] = (uint32_t)r;
    }
}

// Full negacyclic polymul via naive NTT (psi-weighted), independent of the
// schoolbook path: z = ipsi .* INTT(NTT(psi.*x) .* NTT(psi.*y)).
void oracle_polymul_ntt(const uint32_t* x, const uint32_t* y, uint32_t* z,
                        uint32_t n, uint32_t q, uint32_t psi) {
    uint32_t* bufX = new uint32_t[n];
    uint32_t* bufY = new uint32_t[n];
    uint32_t* wx = new uint32_t[n];
    uint32_t* wy = new uint32_t[n];
    uint32_t omega = (uint32_t)((__uint128_t)psi * psi % q);
    uint64_t pw = 1;
    for (uint32_t i = 0; i < n; ++i) {
        wx[i] = (uint32_t)((__uint128_t)x[i] * pw % q);
        wy[i] = (uint32_t)((__uint128_t)y[i] * pw % q);
        pw = (uint64_t)((__uint128_t)pw * psi % q);
    }
    oracle_ntt_naive(wx, bufX, n, q, omega);
    oracle_ntt_naive(wy, bufY, n, q, omega);
    for (uint32_t i = 0; i < n; ++i)
        bufX[i] = (uint32_t)((__uint128_t)bufX[i] * bufY[i] % q);
    oracle_intt_naive(bufX, z, n, q, omega);
    uint64_t psi_inv = powmod(psi, q - 2, q);
    pw = 1;
    for (uint32_t i = 0; i < n; ++i) {
        z[i] = (uint32_t)((__uint128_t)z[i] * pw % q);
        pw = (uint64_t)((__uint128_t)pw * psi_inv % q);
    }
    delete[] bufX; delete[] bufY; delete[] wx; delete[] wy;
}

}  // extern "C"
