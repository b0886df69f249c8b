"""topiaxl_torch imports with JAX, flax, optax, orbax and the JAX package
(``topiaxl``) blocked, and neither its sources nor ``chip_smoke.py`` name
them."""

import pathlib
import re
import subprocess
import sys
import textwrap

ROOT = pathlib.Path(__file__).resolve().parents[1]
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "topiaxl")
# an import of the JAX package; ``topiaxl_torch`` does not match
JAX_PACKAGE_IMPORT = re.compile(r"\b(from|import)\s+topiaxl(?!_torch)\b")


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
        import topiaxl_torch.core.config
        import topiaxl_torch.registry
        import topiaxl_torch.extract
        import topiaxl_torch.extract.glb
        import topiaxl_torch.extract.objio
        import topiaxl_torch.native
        import topiaxl_torch.ops.int8
        import topiaxl_torch.benchmarks.microbench_int8
        import topiaxl_torch.benchmarks.exp_dot_forms
        import topiaxl_torch.render
        import topiaxl_torch.render.geom
        import topiaxl_torch.models.matting_u2net
        import topiaxl_torch.pipelines.losses
        import topiaxl_torch.pipelines.train_vae
        import topiaxl_torch.pipelines.fit
        import topiaxl_torch.extract.mesh_sdf
        import topiaxl_torch.cli.prepare_data
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


def test_port_sources_do_not_import_the_jax_package():
    """No module of the port, and not chip_smoke.py, imports ``topiaxl``;
    the pattern sees such an import and passes the port's own."""
    assert JAX_PACKAGE_IMPORT.search("from topiaxl.extract import glb")
    assert JAX_PACKAGE_IMPORT.search("    import topiaxl.core.config")
    assert JAX_PACKAGE_IMPORT.search("import topiaxl")
    assert not JAX_PACKAGE_IMPORT.search("from topiaxl_torch.extract import x")
    assert not JAX_PACKAGE_IMPORT.search("import topiaxl_torch.native")
    paths = [*(ROOT / "topiaxl_torch").rglob("*.py"), ROOT / "chip_smoke.py"]
    for path in paths:
        for n, line in enumerate(path.read_text().splitlines(), 1):
            assert not JAX_PACKAGE_IMPORT.search(line), f"{path}:{n}: {line}"
