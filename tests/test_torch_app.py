"""topiaxl_torch's demo app (``topiaxl_torch/app.py``) on the CPU at the
tiny config of ``tests/test_torch_pipeline.py``: the three-stage flow of
JAX's ``tests/test_cli.py:179-210`` (preprocess, generate and preview,
export re-run at other knobs without sampling again), the headless entry
point, and the UI's fallback where ``gradio`` is absent."""

import os

import numpy as np
import pytest

from test_torch_models import torch_threads  # noqa: F401
from test_torch_pipeline import _tiny_config


@pytest.fixture()
def blob(tmp_path):
    import cv2

    img = np.zeros((96, 96, 3), np.uint8)
    cv2.circle(img, (48, 48), 30, (210, 180, 255), -1)
    p = tmp_path / "blob.png"
    cv2.imwrite(str(p), img)
    return p


def test_app_staged_pipeline(tmp_path, blob):
    """preprocess -> generate (+ preview) -> export; export again at another
    marching-cubes resolution from the same PrimX: a different GLB, which
    parses, and the same ``denoised.npz``."""
    from topiaxl.extract.glb import read_glb
    from topiaxl_torch.app import App

    app = App(str(_tiny_config(tmp_path, tmp_path)),
              workdir=str(tmp_path / "app"))
    pre = app.preprocess(str(blob))
    assert pre.shape[-1] == 3 and pre.max() <= 255.0
    with pytest.raises(RuntimeError, match="generate"):
        app.export()
    app.generate(steps=3, cfg_scale=2.0, seed=0)
    assert app.primx.srt.shape == (64, 4)
    npz = tmp_path / "app" / "denoised.npz"
    first = np.load(npz)["srt"]
    assert os.path.exists(app.preview())
    glb1 = app.export(mc_resolution=32, decimate=3000, texture_size=128)
    size1 = os.path.getsize(glb1)
    glb2 = app.export(mc_resolution=48, decimate=3000, texture_size=128)
    assert os.path.getsize(glb2) != size1
    gltf, _ = read_glb(glb2)
    assert gltf["asset"]["version"] == "2.0"
    np.testing.assert_array_equal(np.load(npz)["srt"], first)


def test_app_main_runs_the_three_stages(tmp_path, blob, capsys, monkeypatch):
    """``python -m topiaxl_torch.app image config k=v``: all three stages
    with the config's knobs (the CPU here, ``inference.ddim=2``), the
    GLB's path printed (under ``runs/app`` of the working directory)."""
    from topiaxl.extract.glb import read_glb
    from topiaxl_torch.app import main

    cfg = _tiny_config(tmp_path, tmp_path)
    monkeypatch.chdir(tmp_path)
    assert main([str(blob), str(cfg), "inference.ddim=2"]) == 0
    glb = capsys.readouterr().out.strip().splitlines()[-1]
    assert glb == os.path.join("runs", "app", "pbr_mesh.glb")
    assert read_glb(glb)[0]["asset"]["version"] == "2.0"


def test_launch_ui_falls_back_without_gradio(capsys):
    """Without ``gradio`` (absent here and on the card's machine) the UI
    prints JAX's headless fallback and builds nothing."""
    import importlib.util

    from topiaxl_torch.app import launch_ui

    if importlib.util.find_spec("gradio") is not None:
        pytest.skip("gradio is installed: launch_ui would serve")
    assert launch_ui("no/such/config.yml") is None
    out = capsys.readouterr().out
    assert "falling back to headless mode" in out
    assert "python -m topiaxl_torch.app" in out
