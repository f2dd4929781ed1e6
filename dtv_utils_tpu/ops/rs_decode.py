"""Reed-Solomon error-correcting decoder.

Receiver-side counterpart of ops/rs.py (the reference system has no RS
decoder — receiving is done by consumer hardware; this completes the
closed loop the reference validates with real receivers, README:26-28).

Design as array programs:
  * syndromes are GF(2)-linear in the codeword bits, so a whole batch of
    packets computes ALL syndromes as ONE int8 matmul
    ``synd_bits = cw_bits @ M`` — the same trick as the encoder;
  * Berlekamp-Massey runs 2t fixed, branchless iterations (jnp.where for
    the conditional update) on [batch, t+1] polynomial registers;
  * Chien search + Forney evaluation are dense [batch, n] table-gather
    math over the device-resident log/exp tables — no data-dependent
    control flow anywhere, everything jits to static shapes.

Handles shortened codes implicitly (a shortened RS(255,239) is decoded as
length-204 positions; errors "located" in the virtual prefix mark the
packet uncorrectable).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from dtv_utils_tpu.core import bits as bitops
from dtv_utils_tpu.core.galois import GF, GF256, gf2_matmul


class RsDecoder:
    """Decoder for the systematic codes RsBitEncoder emits: ``k_sym`` data
    symbols + ``nroots`` parity, roots alpha^{first_root + i*root_step}."""

    def __init__(self, gf: GF, k_sym: int, nroots: int,
                 first_root: int = 0, root_step: int = 1):
        assert root_step == 1, "Chien/Forney below assume consecutive roots"
        self.gf = gf
        self.k_sym = k_sym
        self.nroots = nroots
        self.t = nroots // 2
        self.n = k_sym + nroots
        self.first_root = first_root
        m, q = gf.m, gf.q
        # --- syndrome bit-matrix: S_j = sum_k cw[k] * alpha^{j*(n-1-k)} ---
        # bit b of symbol k contributes mul(1<<b, alpha^{j*(n-1-k)}) to S_j.
        M = np.zeros((self.n * m, nroots * m), dtype=np.int8)
        for k in range(self.n):
            for j in range(nroots):
                w = gf.pow_alpha((first_root + j) * (self.n - 1 - k))
                for b in range(m):
                    val = int(gf.mul(1 << b, w))
                    # symbol bits MSB-first (core/bits convention)
                    for ob in range(m):
                        if (val >> (m - 1 - ob)) & 1:
                            M[k * m + (m - 1 - b), j * m + ob] = 1
        self.synd_M = M
        # Device GF tables.  Construction may first happen INSIDE a jit
        # trace (the cached DVBT_RS_DEC() singleton is typically touched
        # from a traced decode fn); without the compile-time-eval guard the
        # asarray results would be tracers cached on self, poisoning every
        # later trace (UnexpectedTracerError).
        import jax
        with jax.ensure_compile_time_eval():
            self.d_log = jnp.asarray(gf.log.astype(np.int32))
            self.d_exp = jnp.asarray(gf.exp.astype(np.int32))
            # Chien/Forney exponent tables over the n real positions:
            # position e (0 = LAST transmitted symbol, degree 0) ->
            # X_e = alpha^e
            e = np.arange(self.n)
            jj = np.arange(nroots + 1)
            self.chien = jnp.asarray(
                gf.exp[(-e[:, None] * jj[None, :]) % (q - 1)]
                .astype(np.int32))
            # X_e^{1-first_root} factor for Forney (char-2: sign-free)
            self.xfact = jnp.asarray(
                gf.exp[(e * (1 - first_root)) % (q - 1)].astype(np.int32))

    # -- device GF helpers ------------------------------------------------
    def _mul(self, a, b):
        out = self.d_exp[self.d_log[a] + self.d_log[b]]
        return jnp.where((a == 0) | (b == 0), 0, out)

    def _inv(self, a):
        return self.d_exp[(self.gf.q - 1) - self.d_log[a]]

    def syndromes(self, cw_words: jnp.ndarray) -> jnp.ndarray:
        """[..., n] symbol words -> [..., nroots] syndrome words (int8 matmul)."""
        cw_bits = bitops.words_to_bits(cw_words, self.gf.m)
        sb = gf2_matmul(cw_bits, self.synd_M)
        return bitops.bits_to_words(sb, self.gf.m)

    def _berlekamp(self, S: jnp.ndarray):
        """S [batch, 2t] -> error-locator C [batch, 2t+1] (C[0]=1), L."""
        nr = self.nroots
        batch = S.shape[0]
        C = jnp.zeros((batch, nr + 1), jnp.int32).at[:, 0].set(1)
        B = jnp.zeros((batch, nr + 1), jnp.int32).at[:, 0].set(1)
        L = jnp.zeros(batch, jnp.int32)
        bden = jnp.ones(batch, jnp.int32)

        # fixed-shift Massey variant: B picks up one x factor per iteration
        # (applied inside the update), which absorbs the classic x^m counter.
        for r in range(nr):
            # discrepancy d = sum_{i=0..r} C[i] * S[r-i]  (deg C <= L <= r)
            d = jnp.zeros(batch, jnp.int32)
            for i in range(min(r + 1, nr + 1)):
                d = d ^ self._mul(C[:, i], S[:, r - i])
            coef = self._mul(d, self._inv(jnp.where(bden == 0, 1, bden)))
            Bx = jnp.concatenate(
                [jnp.zeros((batch, 1), jnp.int32), B[:, :-1]], axis=1)
            Cn = C ^ self._mul(coef[:, None], Bx)
            upgrade = (d != 0) & (2 * L <= r)
            B = jnp.where(upgrade[:, None], C, Bx)
            L = jnp.where(upgrade, r + 1 - L, L)
            bden = jnp.where(upgrade, d, bden)
            C = jnp.where((d != 0)[:, None], Cn, C)
        return C, L

    def decode_words(self, cw: jnp.ndarray):
        """cw int32 [batch, n] -> (corrected [batch, n], n_errors [batch],
        ok [batch] bool).  ``ok`` is False when the packet had more than t
        errors (detected: locator degree mismatch or virtual-prefix root)."""
        cw = cw.astype(jnp.int32)
        S = self.syndromes(cw).astype(jnp.int32)         # [batch, 2t]
        clean = jnp.all(S == 0, axis=-1)
        C, L = self._berlekamp(S)

        # Chien over the n real positions: lam[e] = Lambda(alpha^{-e})
        # C [batch, nr+1] x chien [n, nr+1]
        terms = self._mul(C[:, None, :], self.chien[None, :, :])
        lam = jax.lax.reduce(terms, np.int32(0), jax.lax.bitwise_xor, (2,))
        is_err = lam == 0                                  # [batch, n]
        n_found = jnp.sum(is_err, axis=-1)

        # Forney: omega = S(x) * C(x) mod x^nroots
        nr = self.nroots
        om_cols = []
        for j in range(nr):
            acc = jnp.zeros(cw.shape[0], jnp.int32)
            for i in range(j + 1):
                acc = acc ^ self._mul(C[:, i], S[:, j - i])
            om_cols.append(acc)
        omega = jnp.stack(om_cols, axis=1)                 # [batch, nr]
        om_terms = self._mul(omega[:, None, :], self.chien[None, :, :nr])
        om_val = jax.lax.reduce(om_terms, np.int32(0),
                                jax.lax.bitwise_xor, (2,))
        # Lambda'(X^{-1}) = sum over odd j of C_j * X^{-(j-1)}
        dl_terms = self._mul(C[:, None, 1::2], self.chien[None, :, 0:nr:2])
        dlam = jax.lax.reduce(dl_terms, np.int32(0),
                              jax.lax.bitwise_xor, (2,))
        mag = self._mul(self._mul(om_val,
                                  self._inv(jnp.where(dlam == 0, 1, dlam))),
                        self.xfact[None, :])
        # is_err/mag are indexed by DEGREE e; codeword index k = n-1-e
        patch = jnp.where(is_err, mag, 0)[:, ::-1]
        corrected = cw ^ patch

        ok = clean | ((n_found == L) & (L <= self.t))
        n_err = jnp.where(clean, 0, n_found)
        return corrected, n_err, ok

    def decode_bytes(self, cw: jnp.ndarray):
        """uint8 [batch, n] (m==8) -> (corrected uint8, n_errors, ok)."""
        assert self.gf.m == 8
        c, n, ok = self.decode_words(cw)
        return c.astype(jnp.uint8), n, ok


@functools.cache
def DVBT_RS_DEC() -> RsDecoder:
    """Decoder for the DVB-T outer code (shortened RS(204,188), t=8)."""
    return RsDecoder(GF256, k_sym=188, nroots=16)
