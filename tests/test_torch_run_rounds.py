"""The port's round driver (``hiast_tpu_torch.cli.run_rounds``) against the
JAX package's, two rounds of the HIAST loop on the CPU from one shared
warmup ``.pth``: the tests/test_cli.py fixture pattern (64x128 PNGs written
by the port's ``write_png``, 4 target and 2 val images), DeepLab-v2 with
layers (1, 1, 1, 1), crop 32x64, 256 bins, float32 training, 3 iterations
a round.

1. Contract, with the full HIAST setting (CCA on): each round leaves the
   same files in both packages (six artifacts, ``model_last`` and
   ``ema_model_last``), both rounds end at ``total_iter``, and round 2's
   weights moved away from round 1's.
2. Numbers, in a setting whose target ``aug_type`` is ``[MS]`` only: the
   strong view is then the weak view in both packages, and the crops and
   copy-paste donors are numpy draws in both, so the two runs see the same
   data.  Round 1's labels and thresholds meet tests/test_torch_cli.py's
   contract bounds (98% of label pixels, thresholds within 0.01); round 2's
   ``class_threshold.npy`` lies within 0.02 of JAX's, and every tensor of
   each round's final student within 0.01 (round 1) and 0.05 (round 2) of
   JAX's in relative L2 norm (measured: thresholds 0.0055, weights 0.0022
   and 0.0099-0.0105, both at the ASPP biases).  The runs differ by the bf16
   generations (labels agree on 99.8%), float32 convolutions summed in
   other orders and JAX's BatchNorm gradient (ROADMAP C6), which Adam's
   first, sign-like steps amplify; round 2 starts from round 1's
   difference.
3. Resume: SIGTERM in round 2, then a re-run skips round 1, skips round 2's
   labels and resumes round 2 from its step 2 checkpoint.
4. ``load_step``: a missing file, a weights-only file and a full state.
"""
import json
import os
import shutil
import signal

import numpy as np
import pytest
import torch

from hiast_tpu_torch.cli import run_rounds
from hiast_tpu_torch.data.png import write_png
from hiast_tpu_torch.utils.checkpoint import load_step
from test_torch_cli import _artifacts, _assert_same_contract

TOTAL_ITER = 3
STATS_FILES = [  # the six artifacts: these and the label PNGs
    "class_mean_probabilities.npy", "class_threshold.npy", "sample_class_stats.json",
    "samples_with_class.json", "statics_class.npy"]


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def tmp_rounds(tmp_path):
    """``tmp_path``, emptied after the test: two rounds of each driver write
    about 2 GB of checkpoints (full states and their ``_mid`` and ``_best``
    copies)."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """4 target and 2 val images of 64x128, and the shared warmup .pth."""
    from hiast_tpu_torch.models.deeplab_v2 import DeepLabV2

    root = tmp_path_factory.mktemp("rounds")
    rng = np.random.default_rng(21)
    os.makedirs(root / "city" / "images")
    train, val = [], []
    for i in range(6):
        write_png(str(root / "city" / "images" / f"t_{i}.png"),
                  rng.integers(0, 255, size=(64, 128, 3)).astype(np.uint8))
        write_png(str(root / "city" / "images" / f"t_{i}_lbl.png"),
                  rng.integers(0, 19, size=(64, 128)).astype(np.uint8))
        entry = {"image_name": f"images/t_{i}.png", "mask_name": f"images/t_{i}_lbl.png"}
        (train if i < 4 else val).append(entry)
    (root / "cityscapes_train.json").write_text(json.dumps(train))
    (root / "cityscapes_val.json").write_text(json.dumps(val))
    model = DeepLabV2(num_classes=19, backbone_layers=(1, 1, 1, 1))
    model.init_weights(torch.Generator().manual_seed(5))
    torch.save(model.state_dict(), root / "warmup.pth")
    return root


def _configs_dir(root, tmp_path, aug_type: str):
    """sl_1.yaml, sl_2.yaml and hiast_setting.yaml, in YAML as tests/test_cli.py
    writes them; ``aug_type`` is the setting's target augmentation."""
    round_yaml = f"""
trainer: 'SelfTrainingTrainer'
model:
  type: 'SelfTrainingSegmentor'
  seg_model:
    backbone_layers: [1, 1, 1, 1]
dataset:
  num_classes: 19
  crop_size: [32, 64]
  target:
    type: 'Cityscapes'
    json_path: '{root}/cityscapes_train.json'
    image_dir: '{root}/city'
    aug_type: [ 'MS' ]
  val:
    type: 'Cityscapes'
    json_path: '{root}/cityscapes_val.json'
    image_dir: '{root}/city'
    resize_size: [ 32, 64 ]
pseudo_policy:
  batch_size: 2
  resize_size: [ 64, 128 ]
  num_hist_bins: 256
  type: 'IAS'
  ias:
    alpha: 0.5
    beta: 0.9
    gamma: 8.0
train:
  batch_size: 4
  lr: 1e-4
  total_iter: {TOTAL_ITER}
  iter_report: 1
  iter_val: {TOTAL_ITER}
validate:
  batch_size: 2
runtime:
  precision:
    compute_dtype: 'float32'
"""
    setting_yaml = f"""
trainer: 'ConsistencySelfTrainingTrainer'
dataset:
  target:
    aug_type: {aug_type}
cst_training:
  is_enabled: True
  cst_loss:
    type: 'SoftCE'
    weight: 0.5
    region: 'ignored'
preprocessor:
  type: 'CopyPaste'
  copy_paste:
    selected_num_classes: 14
"""
    configs = tmp_path / "configs"
    os.makedirs(configs)
    for name in ("sl_1.yaml", "sl_2.yaml"):
        (configs / name).write_text(round_yaml)
    (configs / "hiast_setting.yaml").write_text(setting_yaml)
    return configs


def _drive_both(root, tmp_path, aug_type):
    """Two rounds through the JAX driver and the port's (on the CPU); returns
    their work dirs."""
    from hiast_tpu.cli import run_rounds as jax_run_rounds

    configs = _configs_dir(root, tmp_path, aug_type)
    work = {"jax": tmp_path / "jax", "port": tmp_path / "port"}
    common = ["--warmup_ckpt", str(root / "warmup.pth"), "--warmup_pseudo_ckpt", str(root / "warmup.pth"),
              "--configs_dir", str(configs), "--rounds", "2"]
    jax_run_rounds.main(["--work_dir", str(work["jax"]), *common])
    run_rounds.main(["--work_dir", str(work["port"]), *common, "--device", "cpu"])
    return work


def _round_files(round_dir, ckpt_suffix=""):
    stats = sorted(e for e in os.listdir(round_dir / "pseudo_label") if e != "gray_label")
    pngs = sorted(os.listdir(round_dir / "pseudo_label" / "gray_label"))
    ckpts = {e[: -len(ckpt_suffix)] if ckpt_suffix and e.endswith(ckpt_suffix) else e
             for e in os.listdir(round_dir / "checkpoints")}
    return stats, pngs, {"model_last", "ema_model_last"} <= ckpts


def _port_student(path) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True)["state_dict"]


def _jax_student(ckpt_dir) -> dict:
    """The JAX round's final student as a port state_dict."""
    import orbax.checkpoint as ocp

    from hiast_tpu_torch.models.convert import flax_to_port_state_dict

    with ocp.StandardCheckpointer() as ckptr:
        state = ckptr.restore(os.path.abspath(os.path.join(ckpt_dir, "model_last")))
    return state, flax_to_port_state_dict({"params": state["params"], "batch_stats": state["batch_stats"]})


def test_two_rounds_keep_the_jax_drivers_contract(root, tmp_rounds):
    work = _drive_both(root, tmp_rounds, "[ 'MS', 'CCA' ]")
    for k in (1, 2):
        jax_round, port_round = work["jax"] / f"sl_{k}", work["port"] / f"sl_{k}"
        got, want = _round_files(port_round, ".pth"), _round_files(jax_round)
        assert got == want, (k, got, want)
        assert got[0] == STATS_FILES and len(got[1]) == 4 and got[2]
        assert load_step(str(port_round / "checkpoints")) == TOTAL_ITER
        jax_state, _ = _jax_student(jax_round / "checkpoints")
        assert int(np.asarray(jax_state["step"])) == TOTAL_ITER
    first = _port_student(work["port"] / "sl_1" / "checkpoints" / "model_last.pth")
    second = _port_student(work["port"] / "sl_2" / "checkpoints" / "model_last.pth")
    assert float((first["backbone.conv1.weight"] - second["backbone.conv1.weight"]).abs().max()) > 0


def _weight_error(got: dict, want: dict) -> tuple[float, str]:
    """The largest |got - want| / |want| (L2 norms) over the tensors."""
    worst, worst_key = 0.0, None
    for key, value in want.items():
        if key.endswith("num_batches_tracked"):
            continue
        value = torch.as_tensor(value).float()
        err = float((got[key].float() - value).norm() / value.norm().clamp(min=1e-12))
        if err > worst:
            worst, worst_key = err, key
    return worst, worst_key


def test_two_rounds_match_the_jax_drivers_numbers(root, tmp_rounds):
    work = _drive_both(root, tmp_rounds, "[ 'MS' ]")
    _assert_same_contract(_artifacts(str(work["port"] / "sl_1" / "pseudo_label" / "gray_label")),
                          _artifacts(str(work["jax"] / "sl_1" / "pseudo_label" / "gray_label")),
                          min_agree=0.98, max_thr_err=0.01)
    thr_got = np.load(work["port"] / "sl_2" / "pseudo_label" / "class_threshold.npy")
    thr_want = np.load(work["jax"] / "sl_2" / "pseudo_label" / "class_threshold.npy")
    thr_err = float(np.abs(thr_got - thr_want).max())
    errors = {}
    for k in (1, 2):
        got = _port_student(work["port"] / f"sl_{k}" / "checkpoints" / "model_last.pth")
        errors[k] = _weight_error(got, _jax_student(work["jax"] / f"sl_{k}" / "checkpoints")[1])
    print(f"round 2: max threshold difference {thr_err:.6f}; largest relative weight difference: round 1 "
          f"{errors[1][0]:.3g} at {errors[1][1]}, round 2 {errors[2][0]:.3g} at {errors[2][1]}")
    assert thr_err <= 0.02
    assert errors[1][0] <= 0.01
    assert errors[2][0] <= 0.05


def test_interrupted_round_resumes(root, tmp_rounds, capsys, monkeypatch):
    from hiast_tpu_torch.utils.recorder import ResultRecorder

    configs = _configs_dir(root, tmp_rounds, "[ 'MS', 'CCA' ]")
    argv = ["--work_dir", str(tmp_rounds / "work"), "--warmup_ckpt", str(root / "warmup.pth"),
            "--warmup_pseudo_ckpt", str(root / "warmup.pth"), "--configs_dir", str(configs),
            "--rounds", "2", "--device", "cpu"]
    # preempt at the 5th recorded iteration: round 2, iteration 2
    record = ResultRecorder.record_losses
    calls = {"n": 0}

    def record_and_preempt(self, losses):
        calls["n"] += 1
        if calls["n"] == 5:
            signal.raise_signal(signal.SIGTERM)
        return record(self, losses)

    monkeypatch.setattr(ResultRecorder, "record_losses", record_and_preempt)
    run_rounds.main(argv)
    monkeypatch.setattr(ResultRecorder, "record_losses", record)

    r1, r2 = tmp_rounds / "work" / "sl_1" / "checkpoints", tmp_rounds / "work" / "sl_2" / "checkpoints"
    assert load_step(str(r1)) == TOTAL_ITER
    assert load_step(str(r2)) == 2
    r1_mtime = os.path.getmtime(r1 / "model_last.pth")
    pseudo2 = tmp_rounds / "work" / "sl_2" / "pseudo_label" / "gray_label"
    pseudo2_mtimes = {e: os.path.getmtime(pseudo2 / e) for e in os.listdir(pseudo2)}
    capsys.readouterr()

    run_rounds.main(argv)
    out = capsys.readouterr().out
    assert "round 1: training already complete" in out
    assert "round 2: resuming interrupted training from step 2" in out
    assert "already exist" in out  # round 2's labels skipped
    assert load_step(str(r2)) == TOTAL_ITER
    assert "ema_model_last.pth" in os.listdir(r2)
    assert os.path.getmtime(r1 / "model_last.pth") == r1_mtime
    assert {e: os.path.getmtime(pseudo2 / e) for e in os.listdir(pseudo2)} == pseudo2_mtimes

    run_rounds.main(argv)  # both rounds done: nothing runs
    out = capsys.readouterr().out
    assert "round 1: training already complete" in out and "round 2: training already complete" in out
    assert "%% IAS" not in out and "already exist" not in out


def test_load_step(tmp_path):
    from hiast_tpu_torch.models.deeplab_v2 import DeepLabV2
    from hiast_tpu_torch.utils.checkpoint import save_train_state

    assert load_step(str(tmp_path)) is None  # missing
    weights = DeepLabV2(num_classes=19, backbone_layers=(1, 1, 1, 1)).state_dict()
    torch.save(weights, tmp_path / "model_last.pth")
    assert load_step(str(tmp_path)) is None  # weights only
    save_train_state(str(tmp_path / "model_last.pth"),
                     {"state_dict": weights, "optimizer": {}, "step": 7, "lr_schedule_step": 7})
    assert load_step(str(tmp_path)) == 7
    assert load_step(str(tmp_path), "ema_model_last") is None
    (tmp_path / "broken.pth").write_bytes(b"not a checkpoint")
    assert load_step(str(tmp_path), "broken") is None
