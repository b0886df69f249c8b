"""topiaxl_torch imports with JAX, flax, optax and orbax blocked, and its
sources never name them."""

import pathlib
import subprocess
import sys
import textwrap

ROOT = pathlib.Path(__file__).resolve().parents[1]
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax")


def test_port_imports_without_jax():
    code = textwrap.dedent(f"""
        import sys

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in {BLOCKED!r}:
                    raise ImportError("blocked: " + name)
                return None

        sys.meta_path.insert(0, Block())
        import topiaxl_torch
        import topiaxl_torch.pipelines.infer
        import topiaxl_torch.cli.infer
        import topiaxl_torch.cli.profile
        import topiaxl_torch.pipelines.synthetic
        import topiaxl_torch.core.weights
        import topiaxl_torch.models.conditioner.image
        import topiaxl_torch.models.latent_stats
        import topiaxl_torch.ops.matting
        import topiaxl_torch.diffusion.timestep_sampler
        import topiaxl_torch.pipelines.train
        import topiaxl_torch.pipelines.data
        import topiaxl_torch.core.checkpoint
        import topiaxl_torch.core.profiling
        import topiaxl_torch.cli.train
        import topiaxl.extract, topiaxl.core.config
        bad = sorted(m for m in sys.modules if m.split(".")[0] in {BLOCKED!r})
        assert not bad, bad
        print("ok")
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_port_sources_do_not_use_jax_or_library_kernels():
    banned = ("import jax", "from jax", "import flax", "from flax",
              "scaled_dot_product_attention", "torch.compile")
    for path in (ROOT / "topiaxl_torch").rglob("*.py"):
        text = path.read_text()
        for word in banned:
            assert word not in text, f"{path}: {word}"
