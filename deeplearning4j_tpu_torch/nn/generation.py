"""Token sampling for autoregressive generation (↔ deeplearning4j_tpu/nn/generation.py).

``sample_token`` is the per-row temperature sampler that ``Gpt.generate``
and the serving engine (``serving/generation.py``) share. Draws come from
an explicit ``torch.Generator`` on the logits' device, where the JAX
package takes a key: the two packages draw different tokens from one
seed, and agree exactly where the choice is greedy.

Not ported yet (ROADMAP queue 1 item 7): ``RnnTimeStepper`` and the
char-RNN ``generate`` loop, which need the recurrent layers' ``step``.
"""

from __future__ import annotations

import torch


def categorical(logits, generator: torch.Generator):
    """One draw per row from softmax(``logits``) over the last axis, by
    the Gumbel-max rule ``jax.random.categorical`` uses: argmax of the
    logits plus Gumbel noise from ``generator``. Returns int64 ids."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device,
                   dtype=torch.float32)
    tiny = torch.finfo(torch.float32).tiny
    gumbel = -torch.log(-torch.log(u.clamp(min=tiny)))
    return torch.argmax(logits.float() + gumbel, dim=-1)


def sample_token(logits, generator: torch.Generator, temperature):
    """Per-row temperature sampling: logits [N,V], temperature [N] →
    [N] int32. Rows with temperature <= 0 take the argmax (greedy), the
    rest draw from softmax(logits / temperature). Greedy and sampled rows
    share one batch: the choice is a ``torch.where``, not Python control
    flow, so a decode step's work does not depend on its request mix."""
    temperature = torch.as_tensor(temperature, device=logits.device).to(
        logits.dtype)
    greedy = torch.argmax(logits, dim=-1)
    tempered = logits / torch.clamp(temperature, min=1e-6)[:, None]
    drawn = categorical(tempered, generator)
    return torch.where(temperature <= 0.0, greedy, drawn).to(torch.int32)
