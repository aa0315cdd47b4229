"""The serve CLI on the hybrid kind (recurrentgemma-9b) against the
reference's, on the CPU: the wave, continuous and paged schedulers'
counts (they follow from the trace, not the weights, which the two
packages draw differently: held exactly), and the direct mode's greedy
tokens with the reference's weights against the reference engine's
prefill and decode of the same prompts (exactly, at temperature 0).
"""
import _torch_threads  # noqa: F401  (torch threads per xdist worker)

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_arch as j_get_arch
from repro.launch import serve as j_serve_cli
from repro.models import build_model as j_build_model

from repro_torch.launch import serve as serve_cli
from repro_torch.models import params_from_jax

from test_torch_hybrid import ARCH, _J
from test_torch_serving import _assert_cli_counts_match


@pytest.mark.parametrize("scheduler", ["paged", "continuous", "wave"])
def test_serve_cli_prints_the_reference_counts(scheduler, capsys):
    """``--arch recurrentgemma-9b --reduced`` (5 layers would be cut to
    the reduced default, 3: one group): the same trace through both
    CLIs, the same done, prefills, decode steps and tokens, and the
    paged scheduler's page line."""
    _assert_cli_counts_match(
        ["--arch", ARCH, "--reduced", "--scheduler", scheduler,
         "--temperature", "0", "--prefill-chunk", "32"], scheduler, capsys)


def test_direct_serve_cli_tokens_match_the_reference_engine(monkeypatch,
                                                            capsys):
    """``--scheduler direct`` with the reference's weights: the CLI's
    greedy tokens equal the reference engine's prefill and decode of the
    CLI's own prompts; the summary's first line equals the reference
    CLI's."""
    argv = ["--arch", ARCH, "--reduced", "--batch", "2", "--prompt-len",
            "24", "--gen", "6", "--temperature", "0"]
    assert j_serve_cli.main(argv) == 0
    ref_lines = capsys.readouterr().out.splitlines()
    jcfg = j_get_arch(ARCH).reduced()
    jp = j_build_model(jcfg).init(jax.random.PRNGKey(0))
    monkeypatch.setattr(serve_cli, "init_params", lambda *a: params_from_jax(
        jax.tree.map(np.asarray, jp), "cpu"))
    assert serve_cli.main(argv + ["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == ref_lines[0]
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size,
                                             size=(2, 24))
    logits, cache, pos = _J["prefill"](
        jp, jcfg, {"tokens": jnp.asarray(toks, jnp.int32)},
        dtype=jnp.float32, cache_dtype=jnp.float32, cache_len=30)
    want = []
    for _ in range(6):
        tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
        want.append(int(tok[0, 0]))
        logits, cache = _J["decode_step"](jp, jcfg, tok, cache, pos,
                                             dtype=jnp.float32)
        pos = pos + 1
    assert lines[-1] == f"sampled token ids (first row): {want}"
