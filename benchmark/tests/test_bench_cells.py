"""A cell added by files alone, run end to end at a tiny size on the CPU's
plain paths; the check failing each fault a cell can have, planted in the
program underneath a run; the lower-precision reference in the program's
place failing it; and, on the card, both controls failing it at the
cells' own size.

The tiny cells live in a temporary copy of the benchmark, added as new
files (a configuration, a traffic mix, limits, a metric reader) and new
``BENCHMARK.json`` entries: no file the benchmark already has changes.
"""

import hashlib
import json
import shutil

import pytest
import torch

import _paths
import run

T2I = {"vocab_words": 50, "config": {
    "transformer": {"num_attention_heads": 4, "num_layers": 1,
                    "num_single_layers": 1, "joint_attention_dim": 512,
                    "pooled_projection_dim": 128},
    "t5": {"d_model": 512, "d_ff": 1024, "num_heads": 8, "d_kv": 64,
           "num_layers": 2, "vocab_size": 300},
    "clip": {"hidden_size": 128, "intermediate_size": 256,
             "num_hidden_layers": 2, "num_attention_heads": 2,
             "vocab_size": 1024},
    "vae": {"block_out_channels": [32, 32, 64, 64], "layers_per_block": 1}}}
T2I_TRAFFIC = {"height": 64, "width": 64, "text_tokens": 16,
               "prompt_words": [2, 6], "steps": 3}
TINY = {
    "flux-tiny": ("flux", {"num_attention_heads": 4, "num_layers": 1,
                           "num_single_layers": 1,
                           "joint_attention_dim": 256,
                           "pooled_projection_dim": 64},
                  "serve-tiny", {"height": 64, "width": 64,
                                 "text_tokens": 8, "steps": 4,
                                 "max_batch": 4, "clients": 6,
                                 "check_span": 3},
                  "images_per_min", "serve-1024", "flux-dev.json"),
    "wan-tiny": ("wan", {"dim": 256, "num_heads": 2, "ffn_dim": 512,
                         "num_layers": 1, "text_dim": 64},
                 "t2v-tiny", {"height": 128, "width": 128, "frames": 5,
                              "text_tokens": 8, "prompt_tokens": [2, 6],
                              "negative_tokens": 5, "steps": 4,
                              "check_span": 3},
                 "video_step_s", "t2v-480p81", "wan2.1-t2v-1.3b.json"),
    "t2i-tiny": ("flux_t2i", T2I["config"], "t2i-tiny", T2I_TRAFFIC,
                 "image_s", "t2i-1024", "flux-dev-t2i.json"),
}
LIMITS = {"fwd_gap": 0.05, "op_gap": 0.02, "update_miss": 0,
          "start_gap": 0.0}
T2I_LIMITS = dict(LIMITS, text_gap=0.05, image_gap=0.05, token_miss=0)
READER = '''"""Mean lanes an engine step advanced in the window."""


def read(m):
    lanes = m.host["lanes_per_tick"]
    return sum(lanes) / len(lanes)
'''


def _deep(d, u):
    for k, v in u.items():
        if isinstance(v, dict) and isinstance(d.get(k), dict):
            _deep(d[k], v)
        else:
            d[k] = v
    return d


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "benchmark").rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("bench")
    shutil.copytree(_paths.BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(_paths.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    before = _digests(root)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    b = root / "benchmark"
    for name, (arch, sizes, traffic, tsizes, e2e, base_traffic,
               base_cfg) in TINY.items():
        cfg = json.loads((b / "configs" / base_cfg).read_text())
        cfg.update(name=name)
        _deep(cfg["config"], sizes)
        if arch == "flux_t2i":
            cfg["vocab_words"] = T2I["vocab_words"]
        (b / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        tr = json.loads((b / "traffic" / f"{base_traffic}.json")
                        .read_text())
        _deep(tr, tsizes)
        (b / "traffic" / f"{traffic}.json").write_text(json.dumps(tr))
        cell = f"{name}.{traffic}"
        limits = T2I_LIMITS if arch == "flux_t2i" else LIMITS
        (b / "limits" / f"{cell}.json").write_text(json.dumps(limits))
        spec["configs"].append({"name": name, "source": "tiny", "file":
                                f"benchmark/configs/{name}.json",
                                "reduced": [], "why": "tiny"})
        spec["workloads"].append({"name": cell, "config": name,
                                  "traffic": traffic, "chips": 1,
                                  "why": "tiny"})
        for m in spec["end_to_end"]:
            if m["name"] == e2e:
                m["workloads"].append(cell)
        spec["per_layer"].append({
            "name": f"engine.mean_lanes.{name}", "unit": "lanes",
            "better": "higher", "source": "host_clock", "layer": "engine",
            "moves": e2e, "workloads": [cell]})
    (b / "metrics" / "engine.mean_lanes.py").write_text(READER)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    after = _digests(root)
    assert {k: v for k, v in after.items() if k in before} == before
    return root


CELLS = ["flux-tiny.serve-tiny", "wan-tiny.t2v-tiny", "t2i-tiny.t2i-tiny"]
E2E = {"flux": "images_per_min", "wan-": "video_step_s", "t2i-": "image_s"}


@pytest.mark.parametrize("cell", CELLS)
def test_a_cell_added_by_files_runs_end_to_end(tiny_root, cell):
    res = run.run_cell(tiny_root, cell, 2**31 + 11, 0.3, False,
                       device="cpu")
    assert res["correct"], res["checks"]
    e2e = E2E[cell[:4]]
    assert set(res["metrics"]) == {"setup_s", e2e}
    assert res["metrics"][e2e]["value"] > 0
    assert list(res)[-1] == "checks"
    assert res["info"]["ops_checked"] >= 2
    assert res["info"].get("lanes_checked",
                           res["info"].get("images_checked")) >= 1
    assert res["checks"]["start_gap"]["value"] == 0.0
    assert res["checks"]["update_miss"]["value"] == 0


@pytest.mark.parametrize("cell", CELLS)
def test_its_metric_reader_is_found_by_name(tiny_root, cell):
    res = run.run_cell(tiny_root, cell, 5, 0.3, True, device="cpu")
    name = "engine.mean_lanes." + cell.split(".")[0]
    assert res["metrics"][name]["value"] >= 1
    assert res["correct"]


def test_the_same_seed_gives_the_same_inputs(tiny_root):
    import numpy as np

    import weights

    cfg = json.loads((tiny_root / "benchmark/configs/flux-tiny.json")
                     .read_text())
    tr = json.loads((tiny_root / "benchmark/traffic/serve-tiny.json")
                    .read_text())
    arch = run._load(tiny_root / "benchmark/models/flux.py", "t_flux")
    a, b, c = (weights.make_raw(arch.groups(cfg), s, "cpu")
               for s in (2**31 + 5, 2**31 + 5, 2**31 + 6))
    assert a.keys() == b.keys()
    assert all(np.array_equal(a[k][2], b[k][2]) for k in a)
    assert not all(np.array_equal(a[k][2], c[k][2]) for k in a)
    drv = run._load(tiny_root / "benchmark/drivers/engine_closed_loop.py",
                    "t_driver")
    r1, r2, r3 = (arch.request(drv._request_gen(s, i, "cpu"), cfg, tr, "cpu")
                  for s, i in ((7, 3), (7, 3), (7, 4)))
    assert torch.equal(r1["latent"], r2["latent"])
    assert torch.equal(r1["cond"]["txt"], r2["cond"]["txt"])
    assert not torch.equal(r1["latent"], r3["latent"])


def _sig_fault(monkeypatch, fn):
    """Break the engine's update underneath: the program's sigma
    broadcast (``pipeline._sig_expand``), which scales each lane's step,
    replaced by ``fn(s, x)``."""
    from comfyui_gguf_tpu_torch import pipeline

    def broken(s, x):
        s = s.to(torch.float32).reshape((x.shape[0],) + (1,) * (x.ndim - 1))
        return fn(s.expand(x.shape).clone())

    monkeypatch.setattr(pipeline, "_sig_expand", broken)


def _fault_unchanged(monkeypatch):
    # every step returns its state unchanged
    _sig_fault(monkeypatch, torch.zeros_like)


def _fault_half_batch(monkeypatch):
    # the second half of the lanes left out of the step
    def half(s):
        s[s.shape[0] - s.shape[0] // 2:] = 0
        return s
    _sig_fault(monkeypatch, half)


def _fault_altered(monkeypatch):
    # one value of the first lane's answer altered where it is produced
    def altered(s):
        s.view(s.shape[0], -1)[0, 0] += 1.0
        return s
    _sig_fault(monkeypatch, altered)


def _euler_fault(monkeypatch, fn):
    """Break the pipeline's sampler underneath: each Euler step's new
    latent passes through ``fn(new, old)``."""
    import numpy as np

    from comfyui_gguf_tpu_torch.sampling import flow_match

    def broken(model_fn, x, sigmas):
        sig = torch.as_tensor(np.asarray(sigmas, np.float32),
                              device=x.device)
        for i in range(sig.shape[0] - 1):
            v = model_fn(x, sig[i])
            new = (x.to(torch.float32) + (sig[i + 1] - sig[i])
                   * v.to(torch.float32)).to(x.dtype)
            x = fn(new, x)
        return x

    monkeypatch.setitem(flow_match.FLOW_SAMPLERS, "euler", broken)


def _t2i_unchanged(monkeypatch):
    _euler_fault(monkeypatch, lambda new, old: old)


def _t2i_altered(monkeypatch):
    def altered(new, old):
        new = new.clone()
        new.view(-1)[0] += 1.0
        return new
    _euler_fault(monkeypatch, altered)


def _t2i_token(monkeypatch):
    # a token altered where the tokenizer makes it
    from comfyui_gguf_tpu_torch.tokenizer import UnigramTokenizer

    orig = UnigramTokenizer.encode
    monkeypatch.setattr(UnigramTokenizer, "encode",
                        lambda self, t, *a, **k: [orig(self, t, *a, **k)[0]
                                                  + 1]
                        + orig(self, t, *a, **k)[1:])


@pytest.mark.parametrize("cell,fault", [
    (CELLS[2], _t2i_unchanged), (CELLS[2], _t2i_altered),
    (CELLS[2], _t2i_token)], ids=["t2i-unchanged", "t2i-altered",
                                  "t2i-token"])
def test_a_broken_pipeline_is_not_correct(tiny_root, monkeypatch, cell,
                                          fault):
    # (a pipeline runs one image: it has no half of a batch to leave out)
    fault(monkeypatch)
    res = run.run_cell(tiny_root, cell, 2**31 + 103, 0.3, False,
                       device="cpu")
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell,fault", [
    (CELLS[0], _fault_unchanged), (CELLS[0], _fault_half_batch),
    (CELLS[0], _fault_altered), (CELLS[1], _fault_unchanged),
    (CELLS[1], _fault_altered)],
    ids=["flux-unchanged", "flux-half_batch", "flux-altered",
         "wan-unchanged", "wan-altered"])
def test_a_broken_timed_path_is_not_correct(tiny_root, monkeypatch, cell,
                                            fault):
    # (the Wan cell runs one lane: it has no half of a batch to leave out)
    fault(monkeypatch)
    res = run.run_cell(tiny_root, cell, 2**31 + 101, 0.3, False,
                       device="cpu")
    assert not res["correct"], res["checks"]


def _fault_no_rope(monkeypatch):
    # RoPE left out of the transformer's attention (flux and Wan alike)
    from comfyui_gguf_tpu_torch.models import flux, wan

    monkeypatch.setattr(flux, "apply_rope", lambda x, pe: x)
    monkeypatch.setattr(wan, "_apply_rope", lambda x, pe: x)


def _fault_half_velocity(monkeypatch):
    # the forward leaves out the second half of the batch: their velocity
    # is 0, so their update is consistent with it
    from comfyui_gguf_tpu_torch.models import flux

    orig = flux.forward_stacked

    def half(*a, **kw):
        out = orig(*a, **kw).clone()
        out[out.shape[0] - out.shape[0] // 2:] = 0
        return out

    monkeypatch.setattr(flux, "forward_stacked", half)


def _fault_uncond_text(monkeypatch):
    # the unconditional branch fed the prompt's text
    from comfyui_gguf_tpu_torch import pipeline

    orig = pipeline._cfg_mix_velocity
    monkeypatch.setattr(pipeline, "_cfg_mix_velocity",
                        lambda fwd, model, ckey="ctx", nkey="nctx", lead=():
                        orig(fwd, model, ckey, ckey, lead))


def _fault_t5_mask(monkeypatch):
    # T5 attends to the padding
    from comfyui_gguf_tpu_torch.models import t5

    orig = t5._attention
    monkeypatch.setattr(t5, "_attention",
                        lambda p, c, x, bias, mask, *a: orig(p, c, x, bias,
                                                             None, *a))


def _fault_vae_attention(monkeypatch):
    # the decoder's middle attention left out
    from comfyui_gguf_tpu_torch.models import vae

    monkeypatch.setattr(vae, "_mid_attn", lambda params, prefix, x, q: x)


@pytest.mark.parametrize("cell,fault,number", [
    (CELLS[0], _fault_no_rope, "fwd_gap"),
    (CELLS[0], _fault_half_velocity, "fwd_gap"),
    (CELLS[1], _fault_no_rope, "fwd_gap"),
    (CELLS[1], _fault_uncond_text, "fwd_gap"),
    (CELLS[2], _fault_no_rope, "fwd_gap"),
    (CELLS[2], _fault_t5_mask, "text_gap"),
    (CELLS[2], _fault_vae_attention, "image_gap")],
    ids=["flux-no_rope", "flux-half_velocity", "wan-no_rope",
         "wan-uncond_text", "t2i-no_rope", "t2i-t5_mask",
         "t2i-vae_attention"])
def test_a_broken_forward_is_not_correct(tiny_root, monkeypatch, cell,
                                         fault, number):
    # faults inside the forwards, which every sampled layer call and the
    # sampler update agree with: the whole-stage gap catches them
    fault(monkeypatch)
    res = run.run_cell(tiny_root, cell, 2**31 + 107, 0.3, False,
                       device="cpu")
    assert not res["correct"], res["checks"]
    row = res["checks"][number]
    assert row["value"] > row["limit"], res["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_lower_precision_reference_is_not_correct(tiny_root, cell):
    # the control of the whole-stage gaps: the reference with every
    # activation rounded to float8 e4m3, in the program's place
    res = run.run_cell(tiny_root, cell, 2**31 + 109, 0.3, False,
                       device="cpu", control="fp8")
    assert not res["correct"], res["checks"]
    for name, value in res["info"]["program"].items():
        row = res["checks"][name]
        assert value <= row["limit"] < row["value"], (name, value, row)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's size")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["w8a8", "fp8"])
@pytest.mark.parametrize("cell", ["flux-dev.serve-1024",
                                  "wan2.1-1.3b.t2v-480p81",
                                  "flux-dev.t2i-1024"])
def test_the_control_is_not_correct(card, cell, kind):
    import control

    res = run.run_cell(_paths.ROOT, cell, 2**31 + 977, 10.0, False,
                       **control.KINDS[kind])
    assert not res["correct"], res["checks"]
