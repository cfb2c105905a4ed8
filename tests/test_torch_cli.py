"""The port's trainer CLI against the JAX package's, from the same files.

A tiny Qwen2 base LLM and SigLIP tower are written locally by ``transformers``
with word-level tokenizers (as ``tests/test_train_cli.py`` does), with 8
image rows and one ``mm_projector.bin`` that both stages start from. JAX runs
``--per-device-train-batch-size 1 --dp 8`` on its 8 virtual CPU devices and
the port ``--per-device-train-batch-size 8 --device cpu``: one global batch of
8 in the same order, so the step losses in ``metrics.jsonl`` must agree (fp32,
rtol 1e-4: other summation orders through 2 tower, 2 guide and 2 decoder
layers, and two Adam steps). Each export loads in both packages.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

VIS = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4, image_size=56,
           patch_size=14)
TXT = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4, vocab_size=99,
           max_position_embeddings=16)
QWEN = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=256, rope_theta=10000.0, tie_word_embeddings=False)
WORDS = ["describe", "the", "picture", "a", "red", "cat", "dog", "number", "<image>", "<video>", "hi", "hello",
         "0", "1", "2", "3"]
STAGE3 = "mm_projector,language_model,vision_model_head,guide_encoder"


def write_tokenizer(dirpath, extra):
    from tokenizers import Tokenizer, models, pre_tokenizers

    vocab = {"<unk>": 0, "<pad>": 1, "</s>": 2}
    for i, w in enumerate(WORDS):
        vocab[w] = 3 + i
    tk = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tk.pre_tokenizer = pre_tokenizers.Whitespace()
    tk.save(os.path.join(dirpath, "tokenizer.json"))
    with open(os.path.join(dirpath, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "PreTrainedTokenizerFast", "unk_token": "<unk>", "pad_token": "<pad>",
                   "eos_token": "</s>", **extra}, f)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    from PIL import Image

    from hicom_tpu_torch.train.checkpoints import export_mm_projector_bin
    from hicom_tpu_torch.train.cli import build_config, build_parser, init_model

    root = tmp_path_factory.mktemp("torchcli")
    llm, tower, imgs = root / "qwen_tiny", root / "siglip_tiny", root / "imgs"
    torch.manual_seed(0)
    transformers.Qwen2ForCausalLM(transformers.Qwen2Config(**QWEN)).save_pretrained(llm)
    write_tokenizer(str(llm), {"chat_template": "{% for m in messages %}{{ m['content'] }}\n{% endfor %}"
                                                "{% if add_generation_prompt %}ASSISTANT:{% endif %}"})
    transformers.SiglipModel(transformers.SiglipConfig(
        vision_config=VIS, text_config=dict(projection_size=64, **TXT))).save_pretrained(tower)
    write_tokenizer(str(tower), {"model_max_length": 16})
    imgs.mkdir()
    rows = []
    for i in range(8):
        Image.fromarray(np.random.default_rng(i).integers(0, 255, (30, 40, 3), dtype=np.uint8)).save(imgs / f"{i}.png")
        rows.append({"image": f"{i}.png", "conversations": [
            {"from": "human", "value": "<image> describe the picture"},
            {"from": "gpt", "value": f"a red cat number {i % 4}"}]})
    data = root / "data.json"
    data.write_text(json.dumps(rows))
    paths = dict(root=root, llm=str(llm), tower=str(tower), data=str(data), imgs=str(imgs))
    # one projector (with its guide injectors) that every stage starts from
    args = build_parser().parse_args(_flags(paths, "stage2", "unused"))
    model = init_model(build_config(args), "cpu", seed=3)
    paths["bin"] = str(root / "start" / "mm_projector.bin")
    export_mm_projector_bin(model.state_dict(), paths["bin"])
    return paths


def _flags(p, stage, out, epochs=2):
    flags = ["--model-path", p["llm"], "--vision-tower", p["tower"], "--mm-projector-type", "local43_global32",
             "--data-path", p["data"], "--data-folder", p["imgs"], "--num-train-epochs", str(epochs),
             "--output-dir", out, "--dtype", "float32", "--logging-steps", "1", "--warmup-ratio", "0",
             "--use-guide", "direct", "--save-steps", "1"]
    if stage == "stage2":
        return flags + ["--mm-tunable-parts", "mm_projector", "--learning-rate", "1e-3", "--guide-injector-lr",
                        "1e-3", "--pretrain-weights", p.get("bin", "")]
    if stage == "sft":
        return flags + ["--mm-tunable-parts", STAGE3, "--learning-rate", "1e-3", "--vision-tower-lr", "2e-4",
                        "--guide-injector-lr", "1e-3", "--pretrain-weights", p["bin"]]
    return flags + ["--mm-tunable-parts", "language_model", "--lora-enable", "--lora-r", "4", "--lora-alpha", "8",
                    "--learning-rate", "1e-2", "--pretrain-weights", p["bin"]]


def _port(p, stage, name, epochs=2):
    from hicom_tpu_torch.train.cli import main

    out = str(p["root"] / name)
    main(_flags(p, stage, out, epochs) + ["--per-device-train-batch-size", "8", "--device", "cpu"])
    return out


@pytest.fixture(scope="module")
def port_stage2(setup):
    return _port(setup, "stage2", "port_stage2")


def _jax(p, stage, name):
    from hicom_tpu.train.cli import main

    out = str(p["root"] / name)
    main(_flags(p, stage, out) + ["--per-device-train-batch-size", "1", "--dp", "8"])
    return out


def _losses(out):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [json.loads(line)["loss"] for line in f]


@pytest.mark.parametrize("stage", ["stage2", "sft"])
def test_step_losses_and_exports_match_jax(setup, port_stage2, stage):
    import hicom_tpu_torch
    from hicom_tpu.api import load_model as jax_load_model
    from hicom_tpu_torch.weights import state_dict_from_jax

    port_out = port_stage2 if stage == "stage2" else _port(setup, stage, f"port_{stage}")
    jax_out = _jax(setup, stage, f"jax_{stage}")
    got, ref = _losses(port_out), _losses(jax_out)
    assert len(got) == len(ref) == 2
    np.testing.assert_allclose(got, ref, rtol=1e-4)

    if stage == "stage2":  # the pretrain layout: the output dir + the base LLM
        art, kw = port_out, dict(model_base=setup["llm"])
        assert os.path.exists(os.path.join(port_out, "mm_projector.bin"))
        assert os.path.exists(os.path.join(jax_out, "mm_projector.bin"))
    else:  # the SFT layout, written by each package and read by the other
        art, kw = os.path.join(port_out, "hf_export"), {}
        thc = hicom_tpu_torch.load_model(os.path.join(jax_out, "hf_export"), dtype="float32", device="cpu")
        jhc = jax_load_model(os.path.join(jax_out, "hf_export"), dtype="float32")
        want = state_dict_from_jax(jax.device_get(jhc.params))
        for k, v in thc.model.state_dict().items():
            assert torch.equal(v, want[k]), k
    thc = hicom_tpu_torch.load_model(art, dtype="float32", device="cpu", **kw)
    jhc = jax_load_model(art, dtype="float32", **kw)
    want = state_dict_from_jax(jax.device_get(jhc.params))
    assert set(want) == set(thc.model.state_dict())
    for k, v in thc.model.state_dict().items():
        assert torch.equal(v, want[k]), k
