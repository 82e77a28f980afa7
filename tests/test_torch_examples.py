"""The port's examples (examples/*_torch.py) against their JAX twins: on a
tiny HF BERT directory (2 layers, hidden 32, weights from a numpy seed,
written by `transformers`), each `_torch` example run with `--device cpu
--weights-dir` prints the lines and numbers of the JAX example run on the same
directory (both as subprocesses, JAX_PLATFORMS=cpu, PYTHONPATH the repo root,
cwd examples/): shapes equal, scores within 1e-4, the best pair equal, the
transport plan within 1e-4 (its printed entries are rounded to 4 places).
Without weights each runs its random tiny encoder."""
import contextlib
import io
import json
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
import transformers

from test_torch_families import numpy_weights

REPO = pathlib.Path(__file__).resolve().parent.parent
EXAMPLES = REPO / "examples"
NAMES = ("consent", "multimatch", "bienc")
TOL = 1e-4
FLOAT = re.compile(r"-?\d+\.\d*(?:e-?\d+)?")


def example_vocab() -> list:
    sys.path.insert(0, str(EXAMPLES))
    try:
        from ex_consent_torch import EX_ABSTRACTS
    finally:
        sys.path.remove(str(EXAMPLES))
    words = sorted({w.lower().strip(".,:") for ex in EX_ABSTRACTS
                    for s in [ex["TITLE"]] + ex["ABSTRACT"] for w in s.split()})
    return ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", ".", ",", ":", "-",
            "fine", "grained", "co", "citation"] + words


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    """Each example's stdout, JAX and port, from one directory; the six
    processes run side by side."""
    d = tmp_path_factory.mktemp("hf")
    vocab = example_vocab()
    (d / "vocab.txt").write_text("\n".join(vocab) + "\n")
    (d / "tokenizer_config.json").write_text(json.dumps(
        {"tokenizer_class": "BertTokenizer", "do_lower_case": True}))
    cfg = transformers.BertConfig(vocab_size=len(vocab), hidden_size=32,
                                  num_hidden_layers=2, num_attention_heads=4,
                                  intermediate_size=64, max_position_embeddings=512)
    numpy_weights(transformers.BertModel(cfg), 4).save_pretrained(
        str(d), safe_serialization=False)
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(REPO),
           "OMP_NUM_THREADS": "1"}
    procs = {}
    for name in NAMES:
        procs[("jax", name)] = [f"ex_{name}.py", "--weights-dir", str(d)]
        procs[("port", name)] = [f"ex_{name}_torch.py", "--weights-dir", str(d),
                                 "--device", "cpu"]
    running = {k: subprocess.Popen([sys.executable, *argv], cwd=EXAMPLES, env=env,
                                   stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                   text=True)
               for k, argv in procs.items()}
    out = {}
    for key, proc in running.items():
        stdout, stderr = proc.communicate(timeout=600)
        assert proc.returncode == 0, f"{key}: {stdout}\n{stderr}"
        out[key] = stdout
    return out


def _line(text: str, prefix: str) -> str:
    return next(ln for ln in text.splitlines() if ln.startswith(prefix))


def _after(text: str, prefix: str) -> str:
    return text[text.index(prefix) + len(prefix):]


@pytest.mark.parametrize("name", NAMES)
def test_example_prints_what_its_jax_twin_prints(outputs, name):
    jax_out, port_out = outputs[("jax", name)], outputs[("port", name)]
    if name == "consent":
        assert _line(port_out, "doc CLS reps:") == _line(jax_out, "doc CLS reps:")
        assert _line(port_out, "best-matching") == _line(jax_out, "best-matching")
        sims = [float(_after(o, "tsAspire similarity:").split()[0])
                for o in (port_out, jax_out)]
        assert sims[0] == pytest.approx(sims[1], abs=TOL)
    elif name == "multimatch":
        sims = [float(_after(o, "otAspire similarity:").split()[0])
                for o in (port_out, jax_out)]
        assert sims[0] == pytest.approx(sims[1], abs=TOL)
        plans = [np.asarray(FLOAT.findall(_after(o, "(query sents x cand sents):")),
                            np.float64) for o in (port_out, jax_out)]
        assert plans[0].shape == plans[1].shape == (9,)
        # rounded to 4 places: a 1e-4 step where the two sit across a boundary
        np.testing.assert_allclose(plans[0], plans[1], atol=TOL + 1e-9)
        assert plans[0].reshape(3, 3).argmax() == plans[1].reshape(3, 3).argmax()
    else:
        assert _line(port_out, "CLS reps:") == _line(jax_out, "CLS reps:")
        sims = [float(_after(o, "bi-encoder similarity (-L2):").split()[0])
                for o in (port_out, jax_out)]
        assert sims[0] == pytest.approx(sims[1], abs=TOL)


def _run_in_process(name: str, argv: list) -> str:
    sys.path.insert(0, str(EXAMPLES))
    try:
        module = __import__(f"ex_{name}_torch")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            module.main(argv)
    finally:
        sys.path.remove(str(EXAMPLES))
    return buf.getvalue()


@pytest.mark.parametrize("name", NAMES)
def test_example_runs_its_random_tiny_encoder(name):
    text = _run_in_process(name, ["--device", "cpu"])
    assert text.startswith("no --weights-dir: using a random tiny encoder")
    numbers = [float(x) for x in FLOAT.findall(text.split("\n", 2)[-1])]
    assert numbers and all(np.isfinite(numbers))
    # the same seeded weights every run
    assert _run_in_process(name, ["--device", "cpu"]) == text


@pytest.mark.skipif(torch.cuda.is_available(), reason="a CUDA device is present")
def test_cuda_is_the_default_device():
    with pytest.raises(RuntimeError, match="cuda"):
        _run_in_process("consent", [])
