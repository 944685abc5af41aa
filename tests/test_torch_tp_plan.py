"""``tools/tp_plan.py``: the port's sizing planner against the JAX
package's, report for report, with the budget passed explicitly; the port
refuses an arch without a head count, and carries no TPU budget."""

import json

import pytest

from comfyui_gguf_tpu.tools import tp_plan as jplan
from comfyui_gguf_tpu_torch.tools import tp_plan


def _rows(mod, capsys, *argv):
    rc = mod.main(["--json", *argv])
    out = capsys.readouterr().out.strip().splitlines()[-1]
    return rc, json.loads(out)


@pytest.mark.parametrize("qtype", ["Q4_K", "Q8_0"])
def test_reports_match_reference(capsys, qtype):
    """Dict for dict, but for AuraFlow at tp = 8: its dims carry no head
    count, so the reference prints it (its fault); the port takes the
    model config's 12 heads, which 8 does not divide."""
    rc, got = _rows(tp_plan, capsys, "--budget-gb", "14.4", "--qtype", qtype)
    jrc, want = _rows(jplan, capsys, "--budget-gb", "14.4", "--qtype", qtype)
    assert rc == jrc == 0
    assert got == [r for r in want if (r["arch"], r["tp"]) != ("aura", 8)]
    assert {"arch": "aura", "tp": 8} in [
        {"arch": r["arch"], "tp": r["tp"]} for r in want]


@pytest.mark.parametrize("arch", ["qwen_image", "hidream"])
def test_one_arch_and_budget(capsys, arch):
    rc, got = _rows(tp_plan, capsys, "--arch", arch, "--budget-gb", "60")
    _, want = _rows(jplan, capsys, "--arch", arch, "--budget-gb", "60")
    assert rc == 0 and got == want
    # HiDream-I1's 20 heads: tp = 8 is not runnable
    assert [r["tp"] for r in got] == ([1, 2, 4] if arch == "hidream"
                                      else [1, 2, 4, 8])


def _no_heads_specs(mod):
    real = mod._specs

    def specs():
        out = dict(real())
        groups, rules, _ = out["flux"]
        out["flux"] = (groups, rules, 0)
        return out

    return specs


def test_an_arch_without_a_head_count_is_refused(capsys, monkeypatch):
    """A falsy head count must not turn the runnability gate off: the port
    prints no tp as runnable for that arch and fails; the reference prints
    every tp (the fault the port does not carry over)."""
    monkeypatch.setattr(tp_plan, "_specs", _no_heads_specs(tp_plan))
    rc, got = _rows(tp_plan, capsys, "--arch", "flux", "--budget-gb", "60")
    assert rc == 2 and got == []
    monkeypatch.setattr(jplan, "_specs", _no_heads_specs(jplan))
    _, want = _rows(jplan, capsys, "--arch", "flux", "--budget-gb", "60")
    assert [r["tp"] for r in want] == [1, 2, 4, 8]


def test_no_tpu_budget(capsys, monkeypatch):
    """Without ``--budget-gb`` the budget is the card's memory less the
    stated margin; without a card the planner refuses."""
    import inspect

    import torch

    src = inspect.getsource(tp_plan)
    assert "14.4" not in src
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tp_plan.main(["--arch", "flux"]) == 2
    assert "--budget-gb" in capsys.readouterr().err

    class Props:
        total_memory = 80 * 10 ** 9

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: Props())
    assert tp_plan.main(["--arch", "flux"]) == 0
    assert f"budget {80 - tp_plan.CARD_MARGIN_GB:.2f} GB" in (
        capsys.readouterr().out)
