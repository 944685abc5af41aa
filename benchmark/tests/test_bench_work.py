"""The work counters behind the roofline shares and the MFU, against
numbers worked out by hand for one block of each model at the cells'
shapes (one lane)."""

import copy
import json

import _paths
from run import _load

FLUX = json.loads((_paths.BENCH / "configs" / "flux-dev.json").read_text())
WAN = json.loads((_paths.BENCH / "configs" /
                  "wan2.1-t2v-1.3b.json").read_text())
SERVE = json.loads((_paths.BENCH / "traffic" / "serve-1024.json")
                   .read_text())
VIDEO = json.loads((_paths.BENCH / "traffic" / "t2v-480p81.json")
                   .read_text())


def _arch(name):
    return _load(_paths.BENCH / "models" / f"{name}.py", f"test_{name}")


def _with(cfg, **keys):
    c = copy.deepcopy(cfg)
    c["config"].update(keys)
    return c


def _block(arch, cfg, traffic, more, less):
    a = arch.work(_with(cfg, **more), traffic, 1)
    b = arch.work(_with(cfg, **less), traffic, 1)
    return {k: (sum(i[0] for i in a[k]) - sum(i[0] for i in b[k]),
                sum(i[1] for i in a[k]) - sum(i[1] for i in b[k]))
            for k in a}


def test_flux_double_block():
    # 4096 image + 512 text tokens, hidden 3072, MLP 12288, 24 heads of
    # 128. Linears: qkv, proj, mlp.0, mlp.2 over both streams' tokens, and
    # the two 6-way modulations at one row each. Weights Q4_K (144 bytes a
    # 256), activations bf16 in and out. Attention: QKᵀ and PV over the
    # joint 4608 tokens, q, k, v and out in bf16.
    w = _block(_arch("flux"), FLUX, SERVE, {"num_layers": 1,
                                            "num_single_layers": 0},
               {"num_layers": 0, "num_single_layers": 0})
    assert w["linear"] == (1043903545344, 644173824)
    assert w["attention"] == (260919263232, 113246208)


def test_flux_single_block():
    w = _block(_arch("flux"), FLUX, SERVE, {"num_layers": 0,
                                            "num_single_layers": 1},
               {"num_layers": 0, "num_single_layers": 0})
    assert w["linear"] == (1043733676032, 476012544)
    assert w["attention"] == (260919263232, 113246208)


def test_wan_block():
    # 21 x 30 x 52 = 32760 tokens, dim 1536, FFN 8960, 12 heads of 128,
    # 512 text tokens; both CFG forwards. Linears: self q, k, v, o and
    # cross q, o over the video tokens, cross k, v over the text, FFN.
    # Attention: self over 32760 keys, cross over 512.
    w = _block(_arch("wan"), WAN, VIDEO, {"num_layers": 1},
               {"num_layers": 0})
    assert w["linear"] == (5471528288256, 5230903296)
    assert w["attention"][0] == 13393805967360
    hd_bytes = 2 * 12 * 128
    assert w["attention"][1] == 2 * hd_bytes * (4 * 32760 + 2 * 32760
                                                + 2 * 512)


def test_wan_tokens():
    assert _arch("wan").n_tokens(WAN, VIDEO) == 32760
