"""A train step of the encoder-decoder on the card against the CPU.
Marked ``cuda``: without a CUDA device the test skips (the card's own
arithmetic is what it checks).  Imports no jax:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_train_cuda.py

One ``build_train_step`` step of the whisper-tiny smoke model (fp32,
TF32 off, the ``library`` backend, as every train step) from the same
seeded weights and batch on both devices, with the CPU tests' bounds:
loss, step loss and grad norm within 1e-5 relative, every gradient
within 1e-4 normwise, the updated parameters within 1e-5 normwise as
one vector (AdamW's first step is lr·g/(|g|+eps) elementwise, so an
element whose gradient is near 0 may move by 2 lr with a sign flip).
"""

import pytest
import torch

from repro_torch.configs import build_model, get_smoke_config
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.train.optim import AdamWConfig
from repro_torch.train.step import (build_train_step, init_train_state,
                                    make_ctx)

pytestmark = [pytest.mark.cuda, pytest.mark.timeout(300)]

LOSS_TOL, GRAD_TOL, PARAM_TOL = 1e-5, 1e-4, 1e-5


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: it holds the card's train step "
                    "against the CPU's")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.cuda.synchronize()
    torch.backends.cuda.matmul.allow_tf32 = tf32


def _norm(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return ((a - b).norm() / b.norm().clamp(min=1e-30)).item()


def test_whisper_train_step_on_the_card_matches_the_cpu(gpu):
    cfg = get_smoke_config("whisper-tiny")
    model = build_model(cfg)
    opt = AdamWConfig(warmup_steps=1, total_steps=10)
    host = init_train_state(model, cfg, opt, torch.Generator().manual_seed(0))
    batch = SyntheticLM(cfg.vocab, 32, 2, audio_dim=cfg.d_model,
                        audio_len=cfg.encoder_len).batch_at(0)
    step, _, _ = build_train_step(model, cfg, opt)
    runs = {}
    for dev in (gpu, torch.device("cpu")):
        state = tree_map(lambda t: t.to(dev), host)
        b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        params = tree_map(lambda t: t.detach().requires_grad_(True),
                          state["params"])
        loss = model.loss(params, b, make_ctx("train"))
        grads = [g.cpu() for g in torch.autograd.grad(
            loss, tree_leaves(params))]
        new, met = step(state, b)
        runs[dev.type] = (loss.item(), grads,
                          {k: v.item() for k, v in met.items()},
                          torch.cat([t.flatten().cpu()
                                     for t in tree_leaves(new["params"])]))
    (loss, grads, met, params), (closs, cgrads, cmet, cparams) = \
        runs["cuda"], runs["cpu"]
    assert abs(loss - closs) <= LOSS_TOL * abs(closs)
    for key in ("loss", "grad_norm"):
        assert abs(met[key] - cmet[key]) <= LOSS_TOL * abs(cmet[key]), key
    assert len(grads) == len(cgrads)
    for g, cg in zip(grads, cgrads):
        assert _norm(g, cg) < GRAD_TOL
    assert _norm(params, cparams) < PARAM_TOL
