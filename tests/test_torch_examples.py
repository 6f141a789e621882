"""The port's example scripts (``examples/torch/``) run in process on the
CPU at mesh 4 (``use_comm(MeshComm(4))``), each with tiny arguments and
``--device cpu``, and import neither JAX nor heat_tpu."""

import functools
import importlib.util
import os
import re

import numpy as np
import pytest

import heat_tpu_torch as htt

ROOT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples", "torch")
SCRIPTS = ("nn/mnist.py", "nn/imagenet.py", "nn/imagenet_daso.py", "nn/moe_lm.py", "nn/elastic.py",
           "cluster/demo_kclustering.py", "classification/demo_knn.py", "lasso/demo.py")


@pytest.fixture
def mesh4():
    htt.use_device("cpu")
    htt.use_comm(htt.MeshComm(4))
    try:
        yield
    finally:
        htt.use_comm(None)
        htt.use_device("gpu")


@pytest.fixture
def narrow_resnets(monkeypatch):
    """The scripts' ResNet-50 and ResNet-18 at one block a stage and four
    filters: the CPU runs their code, not their width."""
    from heat_tpu_torch.models import resnet

    for name, block in (("ResNet50", resnet.BottleneckBlock), ("ResNet18", resnet.BasicBlock)):
        monkeypatch.setattr(htt.models, name, functools.partial(resnet.ResNet, stage_sizes=[1, 1], block_cls=block,
                                                                num_filters=4))


def _main(rel):
    spec = importlib.util.spec_from_file_location("example_" + rel.replace("/", "_")[:-3], os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


def test_scripts_mirror_the_jax_examples_and_import_no_jax():
    jax_root = os.path.join(os.path.dirname(ROOT))
    for rel in SCRIPTS:
        assert os.path.exists(os.path.join(jax_root, rel)), rel
        src = open(os.path.join(ROOT, rel)).read()
        assert not re.search(r"^\s*(import|from) (jax|heat_tpu)(\.| |$)", src, re.M), rel
        assert "--device" in src and "def main(argv=None)" in src, rel


def test_mnist(mesh4, tmp_path):
    # the synthetic set's 512 images: 2 steps
    acc = _main("nn/mnist.py")(["--epochs", "1", "--batch-size", "256", "--data", str(tmp_path), "--device", "cpu"])
    assert 0.0 <= acc <= 1.0


def test_imagenet(mesh4, narrow_resnets):
    losses = _main("nn/imagenet.py")(["--epochs", "1", "--batch-size", "8", "--steps-per-epoch", "2",
                                      "--image-size", "32", "--classes", "10", "--device", "cpu"])
    assert len(losses) == 2 and np.isfinite(losses).all()


def test_imagenet_daso(mesh4, narrow_resnets):
    history = _main("nn/imagenet_daso.py")(["--slices", "2", "--epochs", "2", "--batch-size", "8", "--image-size",
                                            "16", "--classes", "4", "--device", "cpu"])
    assert len(history) == 2 and np.isfinite(history).all()


def test_moe_lm(mesh4):
    nll = _main("nn/moe_lm.py")(["--steps", "3", "--experts", "4", "--layers", "1", "--seq-len", "16",
                                 "--batch-size", "4", "--vocab", "32", "--device", "cpu"])
    assert np.isfinite(nll)


def test_elastic(mesh4, tmp_path):
    report, final = _main("nn/elastic.py")(["--steps", "30", "--checkpoint-every", "10", "--ckpt-dir",
                                            str(tmp_path / "ckpt"), "--device", "cpu"])
    # the NaN at step 17 and the crash at step 23 each restore a checkpoint
    assert report.restarts == 2 and [e["kind"] for e in report.events].count("restore") == 2 and np.isfinite(final)


def test_demo_kclustering(mesh4):
    fitted = _main("cluster/demo_kclustering.py")(["--device", "cpu"])
    assert len(fitted) == 9
    for (name, n, radius), centres in fitted.items():
        assert centres.shape == (4, 3) and np.isfinite(centres).all(), name
        # every fitted centre lies near the space diagonal, where the spheres are
        assert np.abs(centres - centres.mean(axis=1, keepdims=True)).max() < 2 * radius + 1, name


def test_demo_knn(mesh4):
    accuracies = _main("classification/demo_knn.py")(["--device", "cpu"])
    assert len(accuracies) == 5 and np.mean(accuracies) > 0.8


def test_lasso_demo(mesh4):
    theta = _main("lasso/demo.py")(["--device", "cpu"])
    # the intercept column's coefficient and the fit's own intercept dropped
    assert theta.shape == (11, 10) and np.isfinite(theta).all()
    # the strongest regularisation keeps fewer features than the weakest
    assert np.count_nonzero(np.abs(theta[:, -1]) > 1e-6) < np.count_nonzero(np.abs(theta[:, 0]) > 1e-6)
