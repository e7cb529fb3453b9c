"""The port's serving driver on the CPU against a JAX prefill + greedy
decode loop run on the same weights and prompts (the port's seeded
weights carried into the JAX package as numpy arrays).

Greedy tokens must be equal: float32 logits agree to ~1e-7 (see
tests/test_torch_models.py), far below the gaps between the top logits
of these random-weight models.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jcfg  # noqa: E402
from repro.models import ApplyOptions as JOpts  # noqa: E402
from repro.models import decode_step as jdecode  # noqa: E402
from repro.models import prefill as jprefill  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import configs as tcfg  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.models.layers import tree_map  # noqa: E402


def _jax_serve(arch, batch, prompt_len, gen, seed, layers=None):
    """serve.py's loop in the JAX package (attn_impl "reference", as its
    CLI), on the port's weights and prompts for ``seed``; ``layers`` cuts
    or extends the reduced config's depth."""
    cfg = jcfg.reduced(jcfg.get_config(arch))
    tc = tcfg.reduced(tcfg.get_config(arch))
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
        tc = dataclasses.replace(tc, num_layers=layers)
    params = tree_map(lambda t: jnp.asarray(t.numpy()),
                      init_params(tc, seed, "cpu"))
    prompts = {k: jnp.asarray(v.float().numpy() if v.is_floating_point()
                              else v.numpy())
               for k, v in serve.make_prompts(tc, batch, prompt_len, seed,
                                              "cpu").items()}
    opts = JOpts(attn_impl="reference")
    logits, cache = jprefill(cfg, opts, params, prompts)
    target = JL.materialize(JM.cache_defs(cfg, batch, prompt_len + gen),
                            jax.random.PRNGKey(0), jnp.float32)

    def place(dst, src):
        if dst.shape == src.shape:
            return src.astype(dst.dtype)
        return jnp.pad(src, [(0, d - s) for d, s in
                             zip(dst.shape, src.shape)]).astype(dst.dtype)

    cache = jax.tree_util.tree_map(place, target, cache)
    nxt = jnp.argmax(logits, axis=-1)[:, None]
    out = []
    for _ in range(gen):
        if cfg.input_mode == "tokens":
            step = {"tokens": nxt}
        else:
            step = {"embeds": 0.05 * jnp.ones((batch, 1, cfg.d_model))}
        logits, cache = jdecode(cfg, opts, params, cache, step)
        nxt = jnp.argmax(logits, axis=-1)[:, None]
        out.append(np.asarray(nxt))
    return np.concatenate(out, axis=1)


@pytest.mark.parametrize("arch,prompt_len", [
    ("qwen3-8b", 32),          # prompt <= block_q 512: the plain core
    ("qwen3-8b", 1024),        # prompt 2 x block_q: the flash op's path
    ("starcoder2-3b", 24),
    ("h2o-danube-3-4b", 40),   # prompt > window 32: ring roll + wrap
    ("musicgen-medium", 16),   # embeds input mode
    ("jamba-v0.1-52b", 40),    # Mamba + attention + MoE: the selective scan
    ("phi3.5-moe-42b-a6.6b", 24),
])
def test_serve_tokens_match_jax_loop(arch, prompt_len):
    batch, gen = 2, 6
    res = serve.main(["--arch", arch, "--reduced", "--batch", str(batch),
                      "--prompt-len", str(prompt_len), "--gen", str(gen),
                      "--quiet"], device="cpu")
    assert res["tokens"] == batch * gen
    assert {"tokens", "wall_s", "sim_time_s", "tok_per_s_sim", "energy_j",
            "final_pcap"} <= res.keys()
    assert res["generated"].shape == (batch, gen)
    np.testing.assert_array_equal(
        res["generated"], _jax_serve(arch, batch, prompt_len, gen, 0))


def test_serve_takes_a_given_config():
    """`serve` drives a ModelConfig directly: jamba at two pattern repeats
    (the decode cache updated in place through both repeats' views) gives
    the reference's tokens; `main` is that call after its flags."""
    cfg = dataclasses.replace(tcfg.reduced(tcfg.get_config(
        "jamba-v0.1-52b")), num_layers=16)
    a = serve.serve(cfg, 2, 20, 4, seed=0, device="cpu")
    assert a["generated"].shape == (2, 4) and a["tokens"] == 8
    np.testing.assert_array_equal(
        a["generated"], _jax_serve("jamba-v0.1-52b", 2, 20, 4, 0, layers=16))
    b = serve.main(["--arch", "jamba-v0.1-52b", "--reduced", "--batch", "2",
                    "--prompt-len", "20", "--gen", "4", "--quiet"],
                   device="cpu")
    c = serve.serve(tcfg.reduced(tcfg.get_config("jamba-v0.1-52b")), 2, 20,
                    4, seed=0, device="cpu")
    np.testing.assert_array_equal(b["generated"], c["generated"])


def test_serve_is_seeded():
    argv = ["--reduced", "--batch", "2", "--prompt-len", "8", "--gen", "4",
            "--quiet"]
    a = serve.main(argv, device="cpu")["generated"]
    b = serve.main(argv, device="cpu")["generated"]
    c = serve.main(argv + ["--seed", "1"], device="cpu")["generated"]
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


@pytest.mark.parametrize("flags", [["--plane"], ["--power", "--plane"],
                                   ["--obs-port", "0"]],
                         ids=["plane", "power-plane", "obs-port"])
def test_plane_and_obs_port_serve_flags_run(flags):
    """``--plane`` alone serves plainly, ``--power --plane`` runs the
    decode loop as tenant "serve" of a `ControlPlane`, ``--obs-port 0``
    serves a scrape endpoint for the call: the generated tokens are the
    plain call's (control changes only the accounting)."""
    argv = ["--reduced", "--quiet", "--batch", "2", "--prompt-len", "8",
            "--gen", "6"]
    seen = []
    res = serve.main(argv + flags, device="cpu",
                     on_obs=lambda srv: seen.append(srv.url))
    plain = serve.main(argv, device="cpu")
    np.testing.assert_array_equal(res["generated"], plain["generated"])
    if "--power" in flags:
        assert res["plane_wall_s"] is not None and res["nrm_wall_s"] is None
        assert res["energy_j"] > 0 and res["final_pcap"] is not None
    if "--obs-port" in flags:
        assert seen == [res["obs_url"]]
        import urllib.error
        import urllib.request
        with pytest.raises(urllib.error.URLError):  # stopped with the call
            urllib.request.urlopen(res["obs_url"] + "/healthz", timeout=2)
    else:
        assert seen == [] and "obs_url" not in res


def test_serve_refuses_to_run_quietly_on_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--reduced", "--quiet"])
