"""`compressed_psum` on four processes, JAX package against the port.

    python tests/multidev/torch_compression_cases.py jax OUT.npz
    python tests/multidev/torch_compression_cases.py torch OUT.npz

`jax` runs `repro.parallel.compression.compressed_psum` (and `_tree`) under
`jax.shard_map` on 4 forced host devices, one row of each case's input a
device; `torch` spawns 4 gloo CPU ranks of the port's, one row each.  Each
writes every rank's result of every case to OUT.npz (bf16 as float32, which
holds it exactly); the torch side exits non-zero when a rank fails or does
not finish within its time limit.  Both make their inputs from the same
numpy seed (`inputs`).  `tests/test_torch_compression.py` runs both and
compares them.
"""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path

import numpy as np

WORLD = 4
RANK_TIMEOUT_S = 120  # for all ranks together
# name -> (bits, dtype, kind): kind "normal" draws standard normals with a
# per-rank spread; "ties" puts x / scale on exact .5 levels (bits 3, the
# group's max |x| 6, so scale 2), where rounding is half to even; "zeros" is
# all zeros (the scale's 1e-12 floor).
CASES = {
    "f32_bits8": (8, "float32", "normal"),
    "f32_bits4": (4, "float32", "normal"),
    "f32_bits16": (16, "float32", "normal"),
    "bf16_bits8": (8, "bfloat16", "normal"),
    "bf16_bits4": (4, "bfloat16", "normal"),
    "bf16_bits16": (16, "bfloat16", "normal"),
    "f32_bits3_ties": (3, "float32", "ties"),
    "f32_bits8_zeros": (8, "float32", "zeros"),
}
TREE_BITS = 8


def inputs(name: str) -> np.ndarray:
    """[WORLD, 64, 33] float32 (rounded to bf16 for a bf16 case: the values
    both packages take)."""
    bits, dtype, kind = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    if kind == "ties":
        x = rng.choice(np.array([-5.0, -3.0, -1.0, 1.0, 3.0, 5.0], np.float32), (WORLD, 64, 33))
        x[0, 0, 0] = 6.0
    elif kind == "zeros":
        x = np.zeros((WORLD, 64, 33), np.float32)
    else:
        x = (rng.standard_normal((WORLD, 64, 33)) *
             np.array([1.0, 3.0, 0.5, 2.0], np.float32)[:, None, None]).astype(np.float32)
    if dtype == "bfloat16":
        import ml_dtypes

        x = x.astype(ml_dtypes.bfloat16).astype(np.float32)
    return x.astype(np.float32)


def tree_inputs() -> dict:
    rng = np.random.default_rng(99)
    return {"a": rng.standard_normal((WORLD, 8, 5)).astype(np.float32),
            "b": {"c": rng.standard_normal((WORLD, 7)).astype(np.float32)}}


def run_jax(out: str) -> None:
    os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={WORLD}"
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.parallel.compression import compressed_psum, compressed_psum_tree

    mesh = jax.make_mesh((WORLD,), ("d",), axis_types=(jax.sharding.AxisType.Auto,))

    def on_ranks(fn, x):
        f = jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=P("d"), out_specs=P("d"),
                                  check_vma=False))
        return f(x)

    res = {}
    for name, (bits, dtype, _) in CASES.items():
        x = jnp.asarray(inputs(name)).astype(dtype)
        y = on_ranks(lambda v, bits=bits: compressed_psum(v, "d", bits), x)
        res[name] = np.asarray(y.astype(jnp.float32))
    t = tree_inputs()
    y = on_ranks(lambda v: compressed_psum_tree(v, "d", TREE_BITS), jax.tree.map(jnp.asarray, t))
    res["tree_a"], res["tree_b_c"] = np.asarray(y["a"]), np.asarray(y["b"]["c"])
    np.savez(out, **res)


def _rank_main(rank: int, out_dir: str) -> None:
    import torch
    import torch.distributed as dist

    from repro_torch.parallel.compression import compressed_psum, compressed_psum_tree

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/rendezvous", rank=rank,
                            world_size=WORLD)
    try:
        res = {}
        for name, (bits, dtype, _) in CASES.items():
            x = torch.from_numpy(inputs(name)[rank:rank + 1]).to(getattr(torch, dtype))
            y = compressed_psum(x, None, bits)
            assert y.dtype == x.dtype and y.shape == x.shape
            res[name] = y.float().numpy()
        t = tree_inputs()
        y = compressed_psum_tree({"a": torch.from_numpy(t["a"][rank:rank + 1]),
                                  "b": {"c": torch.from_numpy(t["b"]["c"][rank:rank + 1])}},
                                 bits=TREE_BITS)
        res["tree_a"], res["tree_b_c"] = y["a"].numpy(), y["b"]["c"].numpy()
        np.savez(Path(out_dir) / f"rank{rank}.npz", **res)
    finally:
        dist.destroy_process_group()


def run_torch(out: str) -> None:
    import multiprocessing as mp
    import tempfile

    with tempfile.TemporaryDirectory() as out_dir:
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_rank_main, args=(r, out_dir)) for r in range(WORLD)]
        deadline = time.monotonic() + RANK_TIMEOUT_S
        for p in procs:
            p.start()
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.0))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
        if hung or failed:
            raise SystemExit(f"ranks {failed} failed (of which {hung} hung past "
                             f"{RANK_TIMEOUT_S} s)")
        ranks = [np.load(Path(out_dir) / f"rank{r}.npz") for r in range(WORLD)]
        np.savez(out, **{k: np.concatenate([r[k] for r in ranks]) for k in ranks[0].files})


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))
    {"jax": run_jax, "torch": run_torch}[sys.argv[1]](sys.argv[2])
