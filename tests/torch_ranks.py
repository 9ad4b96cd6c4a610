"""Helpers of the multi-rank parity tests: the port's side on D gloo ranks
(spawned processes that meet through a ``FileStore``, so no port is taken
and test workers never collide), the JAX side in a subprocess with forced
host devices (as tests/test_multidevice.py runs it)."""
import os
import queue
import subprocess
import sys
import textwrap
import time
import traceback

import torch.multiprocessing as mp

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")


def _entry(target: str, rank: int, world: int, store: str, args: tuple, q) -> None:
    import importlib

    import torch

    torch.set_num_threads(1)
    from repro_torch.launch import mesh

    try:
        group = mesh.init_group("gloo", rank=rank, world_size=world, store_path=store)
        mod, fn = target.split(":")
        q.put((rank, True, getattr(importlib.import_module(mod), fn)(rank, group, *args)))
    except BaseException:  # reported to the parent, which fails the test with it
        q.put((rank, False, traceback.format_exc()))
        raise
    finally:
        mesh.close()


def run_ranks(target: str, world: int, store: str, *args, timeout: float = 600.0) -> list:
    """Call ``module:function(rank, group, *args)`` on ``world`` gloo CPU
    ranks; returns the results in rank order, or raises with the first
    failing rank's traceback."""
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_entry, args=(target, r, world, store, args, q)) for r in range(world)]
    for p in procs:
        p.start()
    results, errors = {}, []
    deadline = time.monotonic() + timeout
    try:
        while len(results) < world and not errors:
            try:
                rank, ok, val = q.get(timeout=5)
            except queue.Empty:  # a rank that died without a word, or the time is up
                dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                if dead or time.monotonic() > deadline:
                    errors.append(f"ranks exited {dead}" if dead else f"no result in {timeout} s")
                continue
            if ok:
                results[rank] = val
            else:
                errors.append(f"rank {rank}:\n{val}")
    finally:
        for p in procs:
            p.join(timeout=5 if errors else 60)
            if p.is_alive():
                p.kill()
                p.join()
    if errors or len(results) != world:
        raise RuntimeError("\n".join(errors) or f"only ranks {sorted(results)} of {world} reported")
    return [results[r] for r in range(world)]


def start_jax(body: str, n_dev: int) -> subprocess.Popen:
    """Start the reference's side: ``body`` in a fresh interpreter with
    ``n_dev`` forced host devices."""
    code = textwrap.dedent(f"""
        import os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count={n_dev}"
        import jax
        import jax.numpy as jnp
        import numpy as np
        from jax.sharding import PartitionSpec as P
        from repro.compat import shard_map
        from repro.launch.mesh import make_test_mesh
        assert jax.device_count() == {n_dev}

        def mesh_of(d):
            return make_test_mesh((d,), ("data",), devices=jax.devices()[:d])
    """) + textwrap.dedent(body)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    return subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)


def finish(proc: subprocess.Popen, timeout: float = 600.0) -> str:
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
    assert proc.returncode == 0, f"STDOUT:\n{out}\nSTDERR:\n{err[-4000:]}"
    return out
