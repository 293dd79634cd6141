"""The operations a step or a call needs, counted from the configuration
and the published operator sizes: the same whatever implements it.

A Chebyshev conv of order K on Fin -> Fout channels over V vertices takes
K projections (2 B V Fin Fout each) and K - 1 operator applies on
min(Fin, Fout) channels (the cheaper of the two evaluation orders); every
sparse apply (Laplacian, pooling, unpooling, the edge operator) counts
2 x non-zeros x channels x batch; dense layers 2 B Fin Fout. An exact
identity operator counts nothing. Backward counts the gradients the step
needs: a trainable layer's weight gradient (its projections again), and
its input gradient (projections and applies again) unless nothing upstream
needs it. Norms, activations and losses' elementwise work are left out.

The count is the published model's: conditions on the encoder widen its
first layer's input by their channels at every vertex, and their input
gradient is counted (the condition nets train through it), however the
program folds them; a residual encoder block counts both its convs, the
1x1 projection of its skip where the widths differ, and its pool.
"""

from __future__ import annotations

import dataclasses

from bench_port.reference.mesh import is_identity, scaled_laplacian
from bench_port.reference.model import _cond_hidden, channels


@dataclasses.dataclass
class Layer:
    proj: float          # operations of the dense products (weights)
    apply: float = 0.0   # operations of the sparse applies
    data_in: bool = False  # reads the step's data, whose gradient nothing needs

    def forward(self) -> float:
        return self.proj + self.apply


def _nnz(m) -> int:
    return 0 if is_identity(m) else int(m.count_nonzero())


class Counter:
    """Operation counts of one configuration on the published matrices."""

    def __init__(self, settings: dict, raw: dict):
        self.s = settings
        self.F = channels(settings)
        self.sizes = [a.shape[0] for a in raw["A"]]
        self.sizes_d = [a.shape[0] for a in raw["A_d"]]
        self.nnz_lap = [_nnz(scaled_laplacian(a)) for a in raw["A"]]
        self.nnz_down = [_nnz(m) for m in raw["D"]]
        self.nnz_up = [_nnz(m) for m in raw["U"]]
        self.nnz_lap_d = [_nnz(scaled_laplacian(a)) for a in raw["A_d"]]
        self.nnz_down_d = [_nnz(m) for m in raw["D_d"]]
        self.n_edges = len(raw["edges"])

    @staticmethod
    def conv(B, V, fin, fout, K, nnz) -> Layer:
        return Layer(K * 2.0 * B * V * fin * fout, (K - 1) * 2.0 * nnz * B * min(fin, fout))

    @staticmethod
    def dense(B, fin, fout) -> Layer:
        return Layer(2.0 * B * fin * fout)

    @staticmethod
    def apply(B, nnz, C) -> Layer:
        return Layer(0.0, 2.0 * nnz * B * C)

    def embed(self, B) -> list[Layer]:
        s = self.s
        hidden = _cond_hidden(s["cond_dim"], s["nz_cond"])
        return [self.dense(B, s["cond_dim"], hidden), self.dense(B, hidden, s["nz_cond"]),
                self.dense(B, s["cond2_dim"], s["nz_cond2"])]

    def encoder(self, B) -> list[Layer]:
        s, F = self.s, self.F
        out, c = [], s["nn_input_channel"] + self._enc_cond()
        for i, f in enumerate(F):
            V, nnz = self.sizes[i], self.nnz_lap[i]
            out.append(dataclasses.replace(self.conv(B, V, c, f, s["K"], nnz), data_in=i == 0))
            if s["use_res_block"]:
                out.append(self.conv(B, V, f, f, s["K"], nnz))
                if c != f:
                    out.append(dataclasses.replace(self.dense(B * V, c, f), data_in=i == 0))
            out.append(self.apply(B, self.nnz_down[i], f))
            c = f
        red = s["reduce_dim"]
        flat = self.sizes[-1] * red
        return out + [self.dense(B * self.sizes[-1], F[-1], red),
                      self.dense(B, flat, s["nz"]), self.dense(B, flat, s["nz"])]

    def _enc_cond(self) -> int:
        """Condition channels at every vertex of the encoder's input."""
        return self.s["nz_cond"] + self.s["nz_cond2"] if self.s["cond_encoder"] else 0

    def encoder_cond_grad(self, B) -> list[Layer]:
        """The input gradient of the encoder's condition channels: the
        first block's layers that read its input, on those channels."""
        s, f, nc = self.s, self.F[0], self._enc_cond()
        if not nc:
            return []
        V = self.sizes[0]
        out = [self.conv(B, V, nc, f, s["K"], self.nnz_lap[0])]
        if s["use_res_block"] and s["nn_input_channel"] + nc != f:
            out.append(self.dense(B * V, nc, f))
        return out

    def decoder(self, B) -> list[Layer]:
        s, F = self.s, self.F
        ncond = s["nz_cond"] + s["nz_cond2"]
        red = s["reduce_dim"]
        out = [self.dense(B, s["nz"] + ncond, self.sizes[-1] * red),
               self.dense(B * self.sizes[-1], red, F[-1])]
        c = F[-1] + ncond
        L = len(F)
        for i in range(L):
            fout, lvl = F[-(i + 1)], L - 1 - i
            V, half = self.sizes[lvl], fout // 2
            out.append(self.apply(B, self.nnz_up[lvl], c))
            if s["affine"]:
                out += [self.conv(B, V, c, half, s["K"], self.nnz_lap[lvl]),
                        self.dense(B * V, c, half)]
                c = half + ncond
            else:
                out += [self.dense(B * V, c, half),
                        self.conv(B, V, half, half, s["K"], self.nnz_lap[lvl]),
                        self.dense(B * V, half, fout)]
                if c != fout:
                    out.append(self.dense(B * V, c, fout))
                c = fout + ncond
        return out + [self.conv(B, self.sizes[0], c, s["nn_input_channel"], s["K"],
                                self.nnz_lap[0])]

    def discriminator(self, B) -> list[Layer]:
        s, F = self.s, self.F
        out, c = [], s["nn_input_channel"] + s["nz_cond"] + s["nz_cond2"]
        for i in range(len(self.sizes_d) - 1):
            out += [self.conv(B, self.sizes_d[i], c, F[i], s["Kd"], self.nnz_lap_d[i]),
                    self.apply(B, self.nnz_down_d[i], F[i])]
            c = F[i]
        return out + [self.conv(B, self.sizes_d[-1], c, 1, s["K"], self.nnz_lap_d[-1])]

    @staticmethod
    def _backward(layers: list[Layer], trainable: bool, first_input_grad: bool) -> float:
        """Weight gradients (if trainable) and input gradients of every
        layer, the first layer's only if `first_input_grad`."""
        total = 0.0
        for i, layer in enumerate(layers):
            if trainable:
                total += layer.proj
            if (i > 0 or first_input_grad) and not layer.data_in:
                total += layer.forward()
        return total

    def train_step(self, B: int) -> float:
        """One GAN step: G's forward (both condition nets, encoder,
        decoder), three discriminator forwards and the edge loss's apply;
        backward through G (weights, and inputs but the data's: the
        encoder's condition channels are inputs), through D
        for G's loss (inputs only) and through D for D's two terms
        (weights, and inputs but the first layer's)."""
        fwd = lambda layers: sum(layer.forward() for layer in layers)
        emb, enc, dec, disc = self.embed(B), self.encoder(B), self.decoder(B), self.discriminator(B)
        edge = 2.0 * 2 * self.n_edges * B * self.s["nn_input_channel"]
        total = 2 * fwd(emb) + fwd(enc) + fwd(dec) + 3 * fwd(disc) + 2 * edge
        total += self._backward(emb, True, False) + self._backward(enc, True, False)
        total += self._backward(self.encoder_cond_grad(B), False, True)
        total += self._backward(dec, True, True)
        total += self._backward(disc, False, True)
        total += 2 * self._backward(disc, True, False)
        return total

    def decode_call(self, B: int) -> float:
        """One padded /sample generation: the condition nets and the decoder."""
        return sum(layer.forward() for layer in self.embed(B) + self.decoder(B))
