"""The port's residency manager (``lifecycle.py``) on the CPU.

The reference's eight tests (``tests/test_lifecycle.py``) on the port's
trees, plus: ``tree_bytes`` equal to the reference's on the same trees
(planar, int8, LoRA-patched, dense), and ``free_tree`` leaving zero-byte
storages that raise on use while the memory is released (the reference's
``Array.delete``; dropping a torch reference frees nothing while the
caller holds one).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfyui_gguf_tpu import lifecycle as jlifecycle
from comfyui_gguf_tpu.gguf.constants import GGMLQuantizationType as JQ
from comfyui_gguf_tpu.lora import LoRAPatch as JLoRAPatch
from comfyui_gguf_tpu.lora import PatchedWeight as JPatchedWeight
from comfyui_gguf_tpu.models.testing import random_planar as jrandom_planar
from comfyui_gguf_tpu.quant import i8 as ji8
from comfyui_gguf_tpu_torch.gguf.constants import GGMLQuantizationType as Q
from comfyui_gguf_tpu_torch.interop import params_from_numpy
from comfyui_gguf_tpu_torch.lifecycle import (ResidencyManager, free_tree,
                                              to_device, to_host,
                                              tree_bytes, tree_leaves)
from comfyui_gguf_tpu_torch.models.testing import random_planar
from comfyui_gguf_tpu_torch.quant.planar import dequantize

torch.set_num_threads(2)
CPU = "cpu"


def _params(mb: float):
    n = int(mb * 2**20 // 4)
    return {"w": torch.zeros((n,), dtype=torch.float32)}


def _freed(t: torch.Tensor) -> bool:
    return t.untyped_storage().nbytes() == 0 or t.numel() == 0


def test_register_free_source_releases_caller_storage():
    """free_source=True releases the caller's tensors after the host copy
    exists; the host copy still round-trips to a usable device tree."""
    reg = ResidencyManager(device=CPU)
    src = _params(1)
    reg.register("m", src, free_source=True)
    assert all(_freed(leaf) for leaf in tree_leaves(src))
    with reg.acquire("m") as p:
        assert float(p["w"].sum()) == 0.0  # re-placed from the host copy
        assert p["w"].numel() == 2**18

    # default stays non-destructive
    reg2 = ResidencyManager(device=CPU)
    src2 = _params(1)
    reg2.register("m", src2)
    assert not _freed(src2["w"])


def test_free_tree_ignores_host_leaves():
    dev = torch.ones((4,))
    tree = {"d": dev, "h": np.ones((4,)), "s": 3}
    free_tree(tree)
    assert _freed(dev)
    np.testing.assert_array_equal(tree["h"], np.ones((4,)))


def test_free_tree_releases_storage_a_caller_still_holds():
    """Dropping the manager's reference frees nothing while a caller holds
    one; free_tree frees the storage itself, under every view of it, and
    the tree's own leaves are emptied, so a later use fails on shapes."""
    base = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    view = base[2:4]
    pq = random_planar(Q.Q4_K, (128, 512), torch.Generator().manual_seed(0),
                       device=CPU)
    qs = pq.qs
    tree = {"w": base, "q": pq}
    free_tree(tree)
    assert view.untyped_storage().nbytes() == 0
    assert base.numel() == 0 and qs.numel() == 0
    assert tree["q"].qs.numel() == 0 and tree["q"].shape == (128, 512)
    with pytest.raises(RuntimeError):
        torch.matmul(torch.ones(2, 8), tree["w"])
    # a numpy-backed tensor cannot be resized: it is emptied all the same
    from_np = torch.from_numpy(np.ones(16, np.float32))
    free_tree([from_np])
    assert from_np.numel() == 0


def test_budget_evicts_lru():
    reg = ResidencyManager(hbm_budget=10 << 20, device=CPU)
    reg.register("a", _params(4))
    reg.register("b", _params(4))
    reg.register("c", _params(4))
    with reg.acquire("a"):
        pass
    with reg.acquire("b"):
        pass
    assert reg.stats()["a"]["resident"] and reg.stats()["b"]["resident"]
    with reg.acquire("c"):
        pass
    st = reg.stats()
    assert st["c"]["resident"]
    assert not st["a"]["resident"]  # oldest evicted
    assert st["b"]["resident"]
    assert reg.device_bytes() <= 10 << 20


def test_evicted_device_copy_is_freed():
    """Eviction frees the manager's device copy even where a stale
    reference to it survives (an engine frame, a caller's local)."""
    reg = ResidencyManager(hbm_budget=6 << 20, device=CPU)
    reg.register("a", _params(4))
    reg.register("b", _params(4))
    stale = reg.resident_params("a")
    reg.resident_params("b")  # evicts a
    assert not reg.stats()["a"]["resident"]
    assert _freed(stale["w"])
    np.testing.assert_array_equal(reg.resident_params("a")["w"].numpy(),
                                  np.zeros(2**20, np.float32))


def test_pinned_never_evicted():
    reg = ResidencyManager(hbm_budget=10 << 20, device=CPU)
    reg.register("a", _params(6))
    reg.register("b", _params(6))
    with reg.acquire("a"):
        with pytest.raises(MemoryError):
            with reg.acquire("b"):
                pass
    # after unpin, b fits (a evicted)
    with reg.acquire("b"):
        pass
    assert reg.stats()["b"]["resident"]
    assert not reg.stats()["a"]["resident"]


def test_reacquire_after_evict_roundtrips_values():
    reg = ResidencyManager(hbm_budget=None, device=CPU)
    v = {"w": torch.arange(8, dtype=torch.float32),
         "nested": {"b": torch.ones((3,), dtype=torch.bfloat16)}}
    reg.register("m", v)
    reg.evict("m")
    with reg.acquire("m") as p:
        np.testing.assert_array_equal(p["w"].numpy(), np.arange(8))
        assert p["nested"]["b"].dtype == torch.bfloat16


def test_planar_quant_leaves_survive():
    pq = random_planar(Q.Q4_K, (64, 512), torch.Generator().manual_seed(0),
                       device=CPU)
    want = dequantize(pq)
    reg = ResidencyManager(device=CPU)
    reg.register("m", {"w": pq})
    reg.evict("m")
    with reg.acquire("m") as p:
        torch.testing.assert_close(dequantize(p["w"]), want, rtol=0, atol=0)
        assert p["w"].qtype == pq.qtype and p["w"].shape == pq.shape


def test_register_duplicate_and_unregister_pinned():
    reg = ResidencyManager(device=CPU)
    reg.register("a", _params(1))
    with pytest.raises(ValueError):
        reg.register("a", _params(1))
    with reg.acquire("a"):
        with pytest.raises(RuntimeError):
            reg.unregister("a")
    reg.unregister("a")
    assert "a" not in reg.stats()


def test_tree_bytes_counts_quant_components():
    pq = random_planar(Q.Q8_0, (128, 512), torch.Generator().manual_seed(1),
                       device=CPU)
    assert tree_bytes({"w": pq}) == pq.nbytes_packed


def _jtree():
    rng = np.random.default_rng(3)
    pq4 = jrandom_planar(JQ.Q4_K, (256, 512), rng)
    pq8 = jrandom_planar(JQ.Q8_0, (128, 512), rng)
    i8 = ji8.requantize_i8(jrandom_planar(JQ.Q4_K, (128, 512), rng))
    patch = JLoRAPatch(up=jnp.ones((128, 4)), down=jnp.ones((4, 512)),
                       mid=None, diff=None, scale=0.5)
    return {"a.weight": pq4, "b.weight": JPatchedWeight(pq8, (patch,)),
            "c.weight": i8, "norm.scale": jnp.ones((64,), jnp.bfloat16),
            "group": {"d.weight": jnp.zeros((16, 8), jnp.float32)}}


def test_tree_bytes_equals_reference():
    """tree_bytes over planar, int8, LoRA-patched and dense leaves (and a
    nested group) equals the reference's on the same arrays."""
    jtree = _jtree()
    ttree = params_from_numpy(jax.tree.map(np.asarray, jtree), CPU)
    assert tree_bytes(ttree) == jlifecycle.tree_bytes(jtree)
    assert tree_bytes(to_host(ttree)) == tree_bytes(ttree)


def test_to_host_and_to_device_copy():
    """Both copies own their storage: freeing the source leaves them."""
    src = {"w": torch.arange(6, dtype=torch.float32)}
    host = to_host(src)
    dev = to_device(host, CPU)
    free_tree(src)
    np.testing.assert_array_equal(host["w"].numpy(), np.arange(6))
    free_tree(host)
    np.testing.assert_array_equal(dev["w"].numpy(), np.arange(6))
