"""The port's YAML reader (vitslam_tpu_torch/config/yaml_lite.py) against
PyYAML's ``yaml.safe_load``: every shipped config and the ``--set`` values
the CLI tests pass give the same Python values, types included (exact
equality; NaN equals NaN), the YAML 1.1 quirks resolve as PyYAML resolves
them, and text outside the subset raises with its line number. With PyYAML
blocked, the port's ``compose`` of each shipped config equals the JAX
package's ``compose`` exactly."""
import glob
import math
import os
import pickle
import subprocess
import sys

import pytest

yaml = pytest.importorskip("yaml")

from vitslam_tpu.config import loader as jloader  # noqa: E402
from vitslam_tpu_torch.config import yaml_lite  # noqa: E402
from torch_weights import shared_jax_cache  # noqa: E402,F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "*.yaml")))
NAMES = [os.path.basename(p)[:-5] for p in CONFIGS]

# the override values tests/test_torch_cli.py passes through --set
SET_VALUES = ["56", "28", "32", "2", "4", "1", "16", "[0,1,1,1]", "float32", "true", "0.5",
              "2000", "sim3_from_points", "test", "/tmp/pytest-of-root/logs", "null",
              "/tmp/x/head.ckpt", "orbax"]
# YAML 1.1 as PyYAML resolves it (not YAML 1.2)
QUIRKS = ["5e-5", "1.0e-4", "1.0e5", "-1.5e+3", "yes", "No", "off", "ON", "010", "0x1F",
          "0b101", "1_000", "+4", "09", "1:30", "1:30.5", ".5", "1.", ".inf", "-.Inf", ".NaN",
          "~", "null", "", "0o17", "tcp://localhost:1234", "a#b", "a # c", "'it''s'",
          '"tab\\there \\u00e9"', '"*aggregator*"', "[[5, 1], [10, 2]]",
          "{log_dir: logs, log_freq: 10}", "{}", "[]", "[1, 2, ]", "- 1\n- 2",
          "a:\n- 1\n- 2\nb: 3", "k: &x {p: 1}\nm:\n  <<: *x\n  q: 2",
          "a: &a\n  x: 1\n  y: 2\nb: &b\n  y: 3\n  z: 4\nc:\n  <<: [*a, *b]\n  w: 0",
          "- a: 1\n  b: 2\n- c: 3", "1: a\nyes: b\nnull: c", "key: 'x: y'", "- - 1\n  - 2\n- - 3",
          "'<<': 1", "---\na: 1", "a: x #c\nb: 'q # r' # s", "a:\n  - x\n  -\n  - y",
          "- &a 3\n- *a", "a: 1\na: 2", "x: 1\ny:"]
# outside the subset: (text, the line the error names)
UNSUPPORTED = [("a: |\n  x", 1), ("a: >\n  x", 1), ("a: 1\nb: !!str 1", 2), ("\ta: 1", 1),
               ("a:\n\tb: 1", 2), ("a: 1\n---\nb: 2", 2), ("? a\n: b", 1),
               ("a: 2001-12-14", 1), ("a: [1,\n  2]", 1), ("a: 'x\n  y'", 1),
               ("a: b\n  c", 2), ("%YAML 1.1\n---\na: 1", 1), ("a: 1\n...\n", 2)]
# malformed for PyYAML too
MALFORMED = ["a: b: c", "*nope", "a: *nope", "a: 1\n b: 2", "- a\nb: 1", "a: -", "a: [a, b]: c"]


def same(a, b) -> bool:
    """Equal values of equal types, recursively, dict keys in the same order."""
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return list(a) == list(b) and all(same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and math.isnan(a):
        return math.isnan(b)
    return a == b


def plain(x):
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, list):
        return [plain(v) for v in x]
    return x


@pytest.mark.parametrize("path", CONFIGS, ids=NAMES)
def test_shipped_config_equals_safe_load(path):
    with open(path) as f:
        text = f.read()
    assert same(yaml_lite.load_file(path), yaml.safe_load(text))


@pytest.mark.parametrize("text", SET_VALUES + QUIRKS)
def test_scalars_and_quirks_equal_safe_load(text):
    assert same(yaml_lite.loads(text), yaml.safe_load(text)), (
        yaml_lite.loads(text), yaml.safe_load(text))


def test_yaml_1_1_resolution():
    """The quirks spelled out: PyYAML resolves YAML 1.1, not 1.2."""
    got = yaml_lite.loads("a: 5e-5\nb: 1.0e-4\nc: yes\nd: off\ne: 010\nf: ~\ng: \"*agg*\"")
    assert got == {"a": "5e-5", "b": 1.0e-4, "c": True, "d": False, "e": 8, "f": None,
                   "g": "*agg*"}
    assert isinstance(got["b"], float)


@pytest.mark.parametrize("text,line", UNSUPPORTED)
def test_outside_the_subset_raises_with_its_line(text, line):
    with pytest.raises(yaml_lite.YAMLError, match=rf"^line {line}:"):
        yaml_lite.loads(text)


@pytest.mark.parametrize("text", MALFORMED)
def test_malformed_raises_as_in_pyyaml(text):
    with pytest.raises(yaml.YAMLError):
        yaml.safe_load(text)
    with pytest.raises(yaml_lite.YAMLError):
        yaml_lite.loads(text)


OVERRIDES = ["img_size=56", "model.depth=2", "model.intermediate_layers=[0,1,1,1]",
             "checkpoint.from_pretrained=null", "logging.log_freq=5"]
COMPOSE_WITHOUT_YAML = """
import pickle, sys
sys.modules["yaml"] = None
from vitslam_tpu_torch.config.loader import compose

def plain(x):
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, list):
        return [plain(v) for v in x]
    return x

out = {}
for name in sys.argv[2:]:
    out[name] = plain(compose(name, sys.argv[1]))
    if name != "default_dataset":  # the data template has no model to override
        out[name + "+set"] = plain(compose(name, sys.argv[1], overrides=%r))
sys.stdout.buffer.write(pickle.dumps(out))
""" % (OVERRIDES,)


def test_compose_without_pyyaml_equals_the_jax_packages():
    """Each shipped config composed by the port in a process where
    ``import yaml`` fails, with and without overrides, equals the JAX
    package's ``compose`` (which reads with PyYAML) exactly."""
    configs = os.path.join(ROOT, "configs")
    r = subprocess.run([sys.executable, "-c", COMPOSE_WITHOUT_YAML, configs, *NAMES],
                       capture_output=True, cwd=ROOT, timeout=120,
                       env=dict(os.environ, PYTHONPATH=ROOT))
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    got = pickle.loads(r.stdout)
    for name in NAMES:
        assert same(got[name], plain(jloader.compose(name, configs))), name
        if name == "default_dataset":
            continue
        want = plain(jloader.compose(name, configs, overrides=OVERRIDES))
        assert same(got[name + "+set"], want), name
