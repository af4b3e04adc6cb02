"""Smoke test of the main path on GPUs, through the entry points users call.

    python chip_smoke.py            # one card: phases (a)-(e)
    python chip_smoke.py --cards 4  # four cards: the multi-device phase only

One card, at qtesla-iii-speed (n=1024, q=8404993) unless a phase says
otherwise:
  (a) `cli correctness --algo all`: every jnp pipeline and Nussbaumer
      against the C++ oracle and the all-ones closed form;
  (b) the served two-operand path (models.polymul_fn) at B=32768: 64 rows
      (first, last, random) against the C++ schoolbook oracle, and the
      all-ones closed form on every row;
  (c) the served fixed-operand path (models.polymul_fixed_fn) at B=32768,
      checked the same way;
  (d) the fused Pallas kernel against `merged` on the full batch, both
      operand shapes, at qtesla-i, qtesla-iii-speed, qtesla-p-i and
      qtesla-p-iii, bit for bit;
  (e) `cli speed` once for the served path.
Four cards, in one process: data parallelism and Ulysses SP at B=65536, and
the four-step SP at qtesla-p-iii, each compared over the full batch with
the single-card served path.

Exits non-zero without a GPU, or when any phase fails.  The last line of
stdout is one JSON object, {"ok": true, "device": {...}}, printed only when
every phase passed.
"""

import argparse
import json
import subprocess
import sys
import time
import traceback

import numpy as np

BATCH = 32768
CARDS_BATCH = 65536
FUSED_SETS = ("qtesla-i", "qtesla-iii-speed", "qtesla-p-i", "qtesla-p-iii")


def _operands(ps, batch: int, seed: int):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, ps.q, (batch, ps.n), dtype=np.uint32),
            rng.integers(0, ps.q, (batch, ps.n), dtype=np.uint32))


def _check_sample(tag, x, y, z, ps):
    from qtesla_ntt.oracle import mismatched_rows, sample_rows
    from qtesla_ntt.utils import native
    oracle = "C++" if native.native_available() else "big-int Python"
    rows = sample_rows(len(x), 64, seed=7)
    bad = mismatched_rows(x, y, z, ps, rows)
    if bad:
        raise AssertionError(f"{tag}: rows {bad[:8]} differ from the "
                             f"{oracle} oracle")
    print(f"  {tag}: {len(rows)} sampled rows match the {oracle} oracle")


def _check_ones(tag, z, ps):
    from qtesla_ntt.oracle import all_ones_square_closed_form
    want = all_ones_square_closed_form(ps).astype(np.uint32)
    if not (np.asarray(z) == want).all():
        raise AssertionError(f"{tag}: all-ones square != closed form")
    print(f"  {tag}: all-ones closed form on all {len(z)} rows")


def _check_equal(tag, got, want):
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape or not (got == want).all():
        raise AssertionError(f"{tag}: differs from the reference")
    print(f"  {tag}: bit-exact on the full batch {got.shape}")


def phase_correctness():
    from qtesla_ntt import cli
    rc = cli.main(["correctness", "--param-set", "qtesla-iii-speed",
                   "--algo", "all"])
    if rc:
        raise AssertionError(f"cli correctness exited {rc}")


def phase_served(batch: int = BATCH):
    from qtesla_ntt.models import polymul_fn, served_algo
    from qtesla_ntt.params import get_params
    ps = get_params("qtesla-iii-speed")
    print(f"  served algo: {served_algo(ps.n)}, B={batch}")
    fn = polymul_fn(ps.name)
    x, y = _operands(ps, batch, 1)
    _check_sample("served two-operand", x, y, fn(x, y), ps)
    ones = np.ones((batch, ps.n), dtype=np.uint32)
    _check_ones("served two-operand", fn(ones, ones), ps)


def phase_fixed(batch: int = BATCH):
    from qtesla_ntt.models import polymul_fixed_fn, served_algo
    from qtesla_ntt.params import get_params
    ps = get_params("qtesla-iii-speed")
    print(f"  served fixed algo: {served_algo(ps.n)}, B={batch}")
    prep, mul = polymul_fixed_fn(ps.name)
    x, a = _operands(ps, batch, 2)
    a = a[0]
    _check_sample("served fixed-operand", x, a, mul(x, prep(a[None])[0]), ps)
    ones = np.ones((batch, ps.n), dtype=np.uint32)
    _check_ones("served fixed-operand", mul(ones, prep(ones[:1])[0]), ps)


def phase_fused(batch: int = BATCH, interpret: bool = False):
    from qtesla_ntt.models import polymul_fixed_fn, polymul_fn
    from qtesla_ntt.ops.ntt_pallas import (polymul_fixed_fused_fn,
                                           polymul_fused_fn)
    from qtesla_ntt.params import get_params
    for name in FUSED_SETS:
        ps = get_params(name)
        x, y = _operands(ps, batch, 3)
        _check_equal(f"fused vs merged [{name}]",
                     polymul_fused_fn(name, interpret=interpret)(x, y),
                     polymul_fn(name, "merged")(x, y))
        prep, mul = polymul_fixed_fn(name, "merged")
        A = prep(y[:1])[0]
        _check_equal(f"fused fixed vs merged [{name}]",
                     polymul_fixed_fused_fn(name, interpret=interpret)(x, A),
                     mul(x, A))


def phase_speed():
    from qtesla_ntt import cli
    rc = cli.main(["speed", "--param-set", "qtesla-iii-speed",
                   "--batch", str(BATCH), "--iters", "100"])
    if rc:
        raise AssertionError(f"cli speed exited {rc}")


def phase_cards(batch: int = CARDS_BATCH, fourstep_batch: int = 16384):
    import jax
    from qtesla_ntt.models import polymul_fn
    from qtesla_ntt.parallel import (make_mesh, polymul_dp_fn,
                                     polymul_fourstep_sharded_fn,
                                     polymul_ulysses_fn)
    from qtesla_ntt.params import get_params
    ndev = len(jax.devices())
    if ndev != 4:
        raise AssertionError(f"--cards 4 needs 4 devices, JAX sees {ndev}")
    ps = get_params("qtesla-iii-speed")
    x, y = _operands(ps, batch, 4)
    want = polymul_fn(ps.name)(x, y)
    _check_equal(f"DP data=4 B={batch}",
                 polymul_dp_fn(ps.name, make_mesh(data=4, model=1))(x, y),
                 want)
    _check_equal(f"Ulysses model=4 B={batch}",
                 polymul_ulysses_fn(ps.name, make_mesh(data=1, model=4))(
                     x, y), want)
    ps = get_params("qtesla-p-iii")
    x, y = _operands(ps, fourstep_batch, 5)
    _check_equal(f"four-step model=4 [{ps.name}] B={fourstep_batch}",
                 polymul_fourstep_sharded_fn(
                     ps.name, make_mesh(data=1, model=4))(x, y),
                 polymul_fn(ps.name)(x, y))


def _run(phases) -> bool:
    ok = True
    for label, fn in phases:
        print(f"phase {label}", flush=True)
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:
            traceback.print_exc()
            print(f"phase {label} FAILED", flush=True)
            ok = False
            continue
        print(f"phase {label} ok ({time.perf_counter() - t0:.1f} s)",
              flush=True)
    return ok


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cards", type=int, choices=(1, 4), default=1,
                   help="4: run only the multi-device phase on four cards")
    args = p.parse_args(argv)

    import jax
    from qtesla_ntt.utils.cache import enable_compile_cache
    from qtesla_ntt.utils.device import require_gpu

    cache = enable_compile_cache()
    dev = require_gpu("chip_smoke.py")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip())
    print(f"compile cache: {cache}")
    print(f"devices: {jax.devices()}", flush=True)

    if args.cards == 4:
        phases = [("cards: DP, Ulysses and four-step on 4 GPUs", phase_cards)]
    else:
        phases = [("a: cli correctness --algo all", phase_correctness),
                  ("b: served two-operand path", phase_served),
                  ("c: served fixed-operand path", phase_fixed),
                  ("d: fused kernel vs merged", phase_fused),
                  ("e: cli speed", phase_speed)]
    if not _run(phases):
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
