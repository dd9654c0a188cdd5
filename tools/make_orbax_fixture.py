"""Write ``tests/data/orbax_small/``: an Orbax checkpoint saved by the JAX
package's ``save_variables`` (its default OCDBT + zstd layout) from a
seeded tree of compressible arrays, and beside it
``tests/data/expected.npz`` with the same leaves (bfloat16 leaves as their
uint16 bits, under the leaf's name plus ``.bf16bits``).

The arrays take few distinct values, so zstd writes compressed blocks and
reading the fixture exercises the libzstd path; the largest leaf exceeds
OCDBT's 1 KiB inline limit and is read through a data-file reference.
Run from the repo root on a machine with JAX and Orbax:

    JAX_PLATFORMS=cpu python tools/make_orbax_fixture.py
"""

import os
import shutil
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "orbax_small")
EXPECTED = os.path.join(ROOT, "tests", "data", "expected.npz")


def fixture_tree(seed: int = 0) -> dict:
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    levels = np.asarray([-1.0, -0.5, 0.0, 0.25, 1.0], np.float32)
    return {
        "params": {
            "dense0": {
                "kernel": levels[rng.integers(0, 5, (96, 40))],
                "bias": np.zeros(40, np.float32),
            },
            "conv0": {"kernel": np.asarray(
                levels[rng.integers(0, 5, (3, 3, 4, 8))], jnp.bfloat16)},
        },
        "batch_stats": {"bn0": {
            "mean": np.repeat(levels, 8).astype(np.float16),
            "var": np.ones(40, np.float32)}},
        "mask": rng.integers(0, 2, (17, 5)).astype(bool),
        "pixels": np.repeat(rng.integers(0, 256, 30).astype(np.uint8), 60),
        "ids": np.tile(np.arange(7, dtype=np.int32), 9),
        "epoch": np.asarray(3, np.int64),
    }


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield ".".join(prefix + (k,)), v


def main() -> int:
    sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_platforms", "cpu")
    from imageclust_tpu.utils.checkpoint import save_variables

    tree = fixture_tree()
    shutil.rmtree(OUT, ignore_errors=True)
    save_variables(OUT, tree)
    flat = {}
    for name, arr in _flat(tree):
        if arr.dtype.name == "bfloat16":
            flat[name + ".bf16bits"] = arr.view(np.uint16)
        else:
            flat[name] = arr
    np.savez_compressed(EXPECTED, **flat)
    size = sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(OUT) for f in fs)
    print(f"wrote {OUT} ({size} bytes) and {EXPECTED}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
