"""Tensor-parallel training of the port (`backbone.forward_train` and
`Model.loss_fn` under a group), against one device.

A subprocess (`tests/_torch_tp_train_ranks.py`) runs 2 gloo ranks on a
(1, 2) mesh: for each of the six families (reduced granite-3-8b,
qwen2-moe-a2.7b, mamba2-2.7b, recurrentgemma-9b, llama-3.2-vision-90b,
seamless-m4t-medium, fp32, remat on) each rank's loss equals the one
device's within rtol 1e-5; each rank's gradient of every leaf equals its
slice of the one-device gradient within 1e-5 x max|g| (the Megatron pair
`TensorParallel.reduce` / `copy`, the split gated norm's `sum`, the
RG-LRU's and the head_dim fallback's `gather`, the vocab-parallel loss);
after one AdamW step the first moment (the clip, by the global norm over
the group) and the params equal too. A planted fault must fail: with
`copy`'s backward all-reduce dropped, the replicated norms' gradients are
off by more than 10% of their max. And on a one-rank group the loss and
every gradient are the no-group step's bit for bit.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.analysis.meta_step import RecordingGroup
from repro_torch.config.registry import get_config
from repro_torch.distributed.sharding import check_tp
from repro_torch.models.model import build_model

TESTS = Path(__file__).resolve().parent
SRC = str(TESTS.parent / "src")
ARCHS = ("granite-3-8b", "qwen2-moe-a2.7b", "mamba2-2.7b",
         "recurrentgemma-9b", "llama-3.2-vision-90b", "seamless-m4t-medium")
TOL = 1e-5


@pytest.fixture(scope="module")
def ranks():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([SRC, str(TESTS)]))
    proc = subprocess.run(
        [sys.executable, str(TESTS / "_torch_tp_train_ranks.py")], env=env,
        capture_output=True, text=True, timeout=400)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("RESULT")][0]
    return json.loads(line[len("RESULT"):])


@pytest.mark.parametrize("arch", ARCHS)
def test_two_ranks_train_to_the_one_device_loss_and_gradients(ranks, arch):
    for rank, out in enumerate(ranks["ranks"]):
        r = out[arch]
        assert abs(r["loss"] - r["loss_one"]) <= TOL * abs(r["loss_one"]), \
            (rank, r["loss"], r["loss_one"])
        for what in ("grad_gaps", "moment_gaps", "param_gaps"):
            worst = max(r[what], key=r[what].get)
            assert r[what][worst] <= TOL, (rank, what, worst,
                                           r[what][worst])


def test_dropped_copy_all_reduce_puts_the_norm_gradients_off(ranks):
    for out in ranks["ranks"]:
        assert out["planted"] and min(out["planted"].values()) > 0.1, \
            out["planted"]


def test_one_rank_group_is_the_no_group_step_bit_for_bit(ranks):
    assert ranks["one_rank"] == {"loss": 0.0, "grads": 0.0}


def test_refused_layouts_stay_refused():
    """A model on a group (training or serving) takes `check_tp`'s
    refusals, in its words: a model axis neither the kv-heads nor head_dim
    divide (reduced granite at 3, starcoder2-7b at 3). The layouts once
    refused here build and train: starcoder2-7b's 36 query heads at 16,
    reduced llama-3.2-vision's cross K/V on the head_dim fallback at 4
    (tests/test_torch_tp_layouts.py trains them against one device)."""
    for cfg, m, words in (
            (get_config("starcoder2-7b"), 3,
             "neither its 4 kv-heads nor head_dim 128 divide the axis"),
            (get_config("granite-3-8b", "reduced"), 3,
             "neither its 2 kv-heads nor head_dim 32 divide the axis")):
        with pytest.raises(NotImplementedError, match=words):
            check_tp(cfg, m)
        with pytest.raises(NotImplementedError, match=words):
            build_model(cfg, device="meta", group=RecordingGroup((1, m)))
    for cfg, m in ((get_config("starcoder2-7b"), 16),
                   (get_config("llama-3.2-vision-90b", "reduced"), 4)):
        check_tp(cfg, m)
        model = build_model(cfg, device="meta", group=RecordingGroup((1, m)))
        assert model.tp.hd_split
