"""BER/FER waterfall sweeps over an Eb/N0 grid.

Reproduces the reference simulator's experiment design
(/root/reference/apps/ldpc_lapack.cpp:533-714): for each Eb/N0 point, draw
random data frames, encode, BPSK-map (2u-1), add AWGN with
N0 = 10^(-EbN0/10), decode with each method, and accumulate bit/frame error
counters; like the reference, every method decodes the *same* noisy frames
per point (the per-point PRNG key is shared across methods). Frame errors
are counted both ways the reference does: truly (vs the transmitted
codeword) and syndrome-detected (ldpc_lapack.cpp:668-707, including the
false-positive/negative discrepancy you can read off the difference).

The scale-up is the point: the reference runs 30 frames/point sequentially
on a CPU; this harness runs millions of frames/point as mesh-sharded batches
with psum-aggregated counters (BASELINE.json config 4).

Outputs: a results table, the same MATLAB/Octave plot script the reference
prints (to_octave, apps/ldpc_lapack.cpp:724-810), JSON, and a matplotlib PNG.
"""

from __future__ import annotations

import dataclasses
import json
import math
import time
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..codes import LdpcCode, get_code
from ..parallel import make_mesh, make_sweep_step, mesh_axis_sizes

__all__ = ["WaterfallResult", "run_waterfall", "DEFAULT_METHODS"]

# the reference's four curves: uncoded-equivalent slicer, bit-flip,
# min-sum (LogDomain), tanh-rule sum-product (ldpc_lapack.cpp:647-666)
DEFAULT_METHODS = ("hard", "bitflip", "minsum", "sumproduct")


@dataclasses.dataclass
class WaterfallResult:
    code_name: str
    ebn0_db: np.ndarray                      # (P,)
    frames_per_point: int
    iterations: int
    methods: tuple[str, ...]
    # per method: arrays of shape (P,)
    ber: dict[str, np.ndarray]               # codeword-bit error rate
    info_ber: dict[str, np.ndarray]          # info-bit error rate
    fer: dict[str, np.ndarray]               # true frame error rate
    fer_detected: dict[str, np.ndarray]      # syndrome-detected FER
    wall_s: float = 0.0

    def to_json(self) -> str:
        def arr(d):
            return {k: [float(x) for x in v] for k, v in d.items()}
        return json.dumps({
            "code": self.code_name,
            "ebn0_db": [float(x) for x in self.ebn0_db],
            "frames_per_point": self.frames_per_point,
            "iterations": self.iterations,
            "methods": list(self.methods),
            "ber": arr(self.ber),
            "info_ber": arr(self.info_ber),
            "fer": arr(self.fer),
            "fer_detected": arr(self.fer_detected),
            "wall_s": self.wall_s,
        }, indent=2)

    def to_octave(self) -> str:
        """MATLAB/Octave plot script, same shape as the reference's stdout
        dump (apps/ldpc_lapack.cpp:724-810): BER curves on figure 1, FER on
        figure 2, semilogy vs Eb/N0."""
        def vec(v):
            return "[" + " ".join(f"{x:.10g}" for x in v) + "]"
        lines = [f"EbN0 = {vec(self.ebn0_db)};"]
        for m in self.methods:
            lines.append(f"ber_{m} = {vec(self.ber[m])};")
            lines.append(f"fer_{m} = {vec(self.fer[m])};")
        colors = dict(zip(self.methods, "krbg" * 8))
        lines.append("figure(1); clf; hold on;")
        for m in self.methods:
            lines.append(f"semilogy(EbN0, ber_{m}, '{colors[m]}-o');")
        lines.append(
            "grid on; xlabel('E_b/N_0 (dB)'); ylabel('BER');"
            f" legend({', '.join(repr(m) for m in self.methods)});"
            f" title('{self.code_name}, {self.iterations} iterations');")
        lines.append("figure(2); clf; hold on;")
        for m in self.methods:
            lines.append(f"semilogy(EbN0, fer_{m}, '{colors[m]}-o');")
        lines.append(
            "grid on; xlabel('E_b/N_0 (dB)'); ylabel('FER');"
            f" legend({', '.join(repr(m) for m in self.methods)});")
        return "\n".join(lines)

    def to_table(self) -> str:
        hdr = "Eb/N0 " + "".join(f"{'BER(' + m + ')':>18}" for m in self.methods)
        rows = [hdr]
        for p, e in enumerate(self.ebn0_db):
            rows.append(f"{e:5.1f} " + "".join(
                f"{self.ber[m][p]:>18.3e}" for m in self.methods))
        return "\n".join(rows)

    def plot(self, path: str) -> None:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(1, 2, figsize=(11, 4.5))
        for m in self.methods:
            axes[0].semilogy(self.ebn0_db, np.maximum(self.ber[m], 1e-12),
                             marker="o", label=m)
            axes[1].semilogy(self.ebn0_db, np.maximum(self.fer[m], 1e-12),
                             marker="o", label=m)
        for ax, ylab in zip(axes, ("BER", "FER")):
            ax.set_xlabel("Eb/N0 (dB)")
            ax.set_ylabel(ylab)
            ax.grid(True, which="both", alpha=0.3)
            ax.legend()
        fig.suptitle(f"{self.code_name}, {self.iterations} iterations, "
                     f"{self.frames_per_point} frames/point")
        fig.tight_layout()
        fig.savefig(path, dpi=120)
        plt.close(fig)


def run_waterfall(
    code: LdpcCode | str = "sim_50_100",
    ebn0_db: Optional[Sequence[float]] = None,
    frames_per_point: int = 30_000,
    iterations: int = 5,
    methods: Sequence[str] = DEFAULT_METHODS,
    mesh=None,
    seed: int = 0,
    early_exit: bool = True,
    progress: bool = False,
    frames_per_step: int = 1 << 17,
    checkpoint: Optional[str] = None,
) -> WaterfallResult:
    """Run the sweep. Defaults mirror the reference experiment: the (100,50)
    code, 35 points -7..10 dB step 0.5 (ldpc_lapack.cpp:543), 5 iterations —
    but at mesh-sharded batch scale instead of 30 frames/point."""
    if isinstance(code, str):
        code = get_code(code)
    if ebn0_db is None:
        ebn0_db = np.arange(-7.0, 10.0 + 0.25, 0.5)
    ebn0_db = np.asarray(ebn0_db, np.float64)
    mesh = mesh or make_mesh(("batch",))
    n_dev = mesh_axis_sizes(mesh)["batch"]
    # split each point into device-sized steps so arbitrarily large
    # frames_per_point (e.g. the 10^7-codewords-per-point configuration)
    # never allocates more than frames_per_step frames at once
    n_steps = max(1, math.ceil(frames_per_point / (frames_per_step * n_dev)))
    fpd = max(1, math.ceil(frames_per_point / (n_dev * n_steps)))
    actual_fpp = fpd * n_dev * n_steps

    steps = {
        m: make_sweep_step(code, mesh, method=m, iterations=iterations,
                           frames_per_device=fpd, early_exit=early_exit)
        for m in methods
    }
    base = jax.random.PRNGKey(seed)
    zeros = lambda: {m: np.zeros(len(ebn0_db)) for m in methods}
    ber, info_ber, fer, ferd = zeros(), zeros(), zeros(), zeros()
    # checkpoint/resume: one JSON line per finished point; a rerun with the
    # same config skips completed points (absent in the reference — its sims
    # restart from scratch; SURVEY.md §5)
    done_points: dict = {}
    cfg_sig = [code.name, int(actual_fpp), int(iterations), list(methods),
               int(seed)]
    if checkpoint:
        import pathlib
        ck = pathlib.Path(checkpoint)
        if ck.exists():
            for line in ck.read_text().splitlines():
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if rec.get("cfg") == cfg_sig:
                    done_points[round(float(rec["ebn0_db"]), 6)] = rec
    t0 = time.perf_counter()
    for p, e in enumerate(ebn0_db):
        rec = done_points.get(round(float(e), 6))
        if rec is not None:
            for m in methods:
                ber[m][p], info_ber[m][p], fer[m][p], ferd[m][p] = rec["stats"][m]
            continue
        for m in methods:
            acc = np.zeros(4)
            nf = nb = 0.0
            for si in range(n_steps):
                # key shared across methods (same frames per point, like the
                # reference), distinct per point and step
                key = jax.random.fold_in(jax.random.fold_in(base, p), si)
                s = steps[m](key, float(e))
                # one host fetch per step, not one per counter
                vals = np.asarray(jnp.stack(list(s)), np.float64)
                acc += vals[:4]
                nf += vals[4]
                nb += vals[5]
            ber[m][p] = acc[0] / nb
            info_ber[m][p] = acc[1] / (nf * code.K)
            fer[m][p] = acc[2] / nf
            ferd[m][p] = acc[3] / nf
        if checkpoint:
            with open(checkpoint, "a") as f:
                f.write(json.dumps({
                    "cfg": cfg_sig, "ebn0_db": float(e),
                    "stats": {m: [ber[m][p], info_ber[m][p], fer[m][p],
                                  ferd[m][p]] for m in methods},
                }) + "\n")
        if progress:
            print(f"  Eb/N0 {e:+5.1f} dB: " + "  ".join(
                f"{m}={ber[m][p]:.3e}" for m in methods), flush=True)
    return WaterfallResult(
        code_name=code.name, ebn0_db=ebn0_db, frames_per_point=actual_fpp,
        iterations=iterations, methods=tuple(methods), ber=ber,
        info_ber=info_ber, fer=fer, fer_detected=ferd,
        wall_s=time.perf_counter() - t0)
