"""The port's YAML reader and writer (``marie_tpu_torch/jaml/parser.py``)
against PyYAML, and its JAML, Flow-from-YAML and exports against the JAX
package's.

* The reader equals ``yaml.safe_load`` on every ``.yml``/``.yaml`` under
  ``config/`` and ``tests/`` (and the project templates and logging config
  of both packages), on the YAML strings of ``tests/unit/test_jaml.py`` and
  ``tests/unit/test_cli_flow_yaml.py``, and on documents PyYAML dumps from
  a hypothesis strategy of nested maps, lists and scalars; the writer's
  output reads back equal through both readers; inputs outside the subset
  raise ``BadConfigSource``.
* ``JAML.expand_dict``, ``JAML.construct`` and ``load_config`` give the
  JAX package's results for the same documents and context.
* ``config/service/marie.yml`` loads into a port Flow whose deployments,
  ``uses``, ``with``, ``needs`` and gateway settings equal the JAX Flow's,
  and in a subprocess with JAX, the JAX package, PyYAML, aiohttp, pydantic
  and PIL blocked it imports none of them.
* The Kubernetes, docker-compose and Mermaid exports equal the JAX ones
  once both are parsed (the image, the CLI command and the accelerator
  resource are the port's own)."""

import math
import os
import pathlib
import subprocess
import sys

import pytest
import yaml
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from marie_tpu_torch.excepts import BadConfigSource
from marie_tpu_torch.jaml import JAML, JAMLCompatible, parser

REPO = pathlib.Path(__file__).resolve().parents[1]


def _same(a, b) -> bool:
    """Equal values of equal types (NaN equal to NaN)."""
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a) and math.isnan(b):
        return True
    if isinstance(a, dict) and isinstance(b, dict):
        return list(a) == list(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return type(a) is type(b) and a == b


def _corpus_files():
    roots = [REPO / "config", REPO / "tests", REPO / "marie_tpu" / "resources",
             REPO / "marie_tpu_torch" / "resources"]
    out = []
    for root in roots:
        out += sorted(p for p in root.rglob("*") if p.suffix in (".yml", ".yaml"))
    return out


@pytest.mark.parametrize("path", _corpus_files(), ids=lambda p: str(p.relative_to(REPO)))
def test_reader_equals_pyyaml_on_the_corpus(path):
    text = path.read_text()
    assert _same(parser.load(text), yaml.safe_load(text))


#: the YAML strings of tests/unit/test_jaml.py and tests/unit/test_cli_flow_yaml.py,
#: and the shapes the service configurations use
DOCS = [
    "port: ${{ ENV.MARIE_TEST_PORT }}\n",
    "port: ${{ ENV.MARIE_NOPE | 9090 }}\n",
    "name: ${{ CONTEXT.name }}\nnested: {v: 'prefix-${{ name }}-suffix'}\n",
    "jtype: DummyEncoder\nwith:\n  dim: 64\n",
    "key: ${{ ENV.MARIE_DEFINITELY_UNSET_VAR_42 }}\n",
    "key: ${{ ENV.MARIE_DEFINITELY_UNSET_VAR_42 | 7777 }}\n",
    "k: ${{ CONTEXT.nope }}\n",
    ("servers:\n  - host: a\n    port: ${{ ENV.MARIE_T_PORT }}\n  - host: b\n"
     "meta:\n  inner:\n    v: ${{ CONTEXT.tag }}\n"),
    """
jtype: Flow
with:
  port: ${{ ENV.TEST_FLOW_PORT }}
  protocol: grpc
executors:
  - name: a
    uses:
      jtype: marie_tpu.executor.TextExtractionExecutorMock
  - name: b
    needs: [a]
    uses:
      jtype: marie_tpu.executor.TextExtractionExecutorMock
""",
    "a: yes\nb: No\nc: on\nd: ~\ne:\nf: 0x1F\ng: 0777\nh: 1:30\ni: 1.5e+3\nj: 1e5\n"
    "k: .inf\nl: -.Inf\nm: 1_000\nn: +12\no: 0b101\np: 190:20:30.15\nq: .nan\n",
    "a: this is\n  a long\n\n  plain scalar\nb: x # comment\nc: x#y\n",
    "a: 'multi\n  line\n\n  quoted'\nb: \"dq \\\n  joined\"\nc: 'it''s'\nd: \"\\t\\u00e9\\x41\"\n",
    "a: |\n  line1\n  line2\n\n  line4\nb: >\n  folded\n  text\n\n  para\n   more\n  end\n"
    "c: |-\n  x\nd: |+\n  y\n\ne: >2\n   kept\nf: end\n",
    "[1, 2,\n  3, {k: v, 'q': \"r\"}, [a b, c]]\n",
    "key:\n- a\n- - x\n  - y\n-\n  z: 1\nother: {}\nempty: []\nq: ''\n",
    "- a: 1\n  b: [1, 2]\n- c: http://x.y/z:1\n  d: -1\n  e: -x\n",
    "'': x\n\"k\": v\n1: one\ntrue: t\nnull: n\n",
    "---\na: 1\n...\n",
    "# only a comment\n",
    "",
]


@pytest.mark.parametrize("text", DOCS, ids=range(len(DOCS)))
def test_reader_equals_pyyaml_on_strings(text):
    assert _same(parser.load(text), yaml.safe_load(text))


OUTSIDE = [
    "a: &x 1\nb: *x\n",  # anchors, aliases
    "a: !!str 1\n",  # tags
    "a: 2001-12-14\n",  # timestamps
    "? a\n: b\n",  # complex keys
    "<<: {a: 1}\n",  # merge keys
    "%YAML 1.1\n---\na: 1\n",  # directives
    "\ta: 1\n",  # tabs in indentation
    "[a: b]\n",  # a single-pair mapping in a flow sequence
    "a: x\x85y\n",  # a NEL line break
    "a: b: c\n",  # not YAML
    "key: [unclosed\n  - broken",  # not YAML
    "a: 1\n b: 2\n",  # not YAML
]


@pytest.mark.parametrize("text", OUTSIDE, ids=range(len(OUTSIDE)))
def test_outside_the_subset_raises_with_the_line(text):
    with pytest.raises(BadConfigSource, match=r"line \d+"):
        parser.load(text)


_keys = st.text(st.characters(blacklist_categories=("Cs", "Cc", "Zl", "Zp")), min_size=1,
                max_size=12)
_text = st.text(st.characters(blacklist_categories=("Cs", "Zl", "Zp"),
                              blacklist_characters="\x85"), max_size=90)
_scalars = st.one_of(st.none(), st.booleans(), st.integers(),
                     st.floats(allow_nan=False), _text, _keys)
_trees = st.recursive(_scalars, lambda c: st.one_of(st.lists(c, max_size=4),
                                                     st.dictionaries(_keys, c, max_size=4)),
                      max_leaves=16)


@settings(max_examples=300, deadline=None, suppress_health_check=list(HealthCheck))
@given(_trees, st.booleans())
def test_reader_reads_what_pyyaml_dumps(tree, unicode):
    text = yaml.safe_dump(tree, sort_keys=False, allow_unicode=unicode)
    assert _same(parser.load(text), yaml.safe_load(text))


@settings(max_examples=300, deadline=None, suppress_health_check=list(HealthCheck))
@given(_trees)
def test_writer_round_trips_through_both_readers(tree):
    text = parser.dump(tree)
    assert _same(yaml.safe_load(text), tree)
    assert _same(parser.load(text), tree)


def test_dump_all_and_load_all():
    docs = [{"a": [1, 2.5, None]}, ["x", {"y": "z: w"}], "s", 3]
    text = parser.dump_all(docs)
    assert list(yaml.safe_load_all(text)) == docs == parser.load_all(text)


# --- JAML ------------------------------------------------------------------------

CONTEXT = {"name": "abc", "tag": "blue", "n": "12", "flag": "yes"}


@pytest.mark.parametrize("text", DOCS[:9] + [
    "a: ${{ CONTEXT.n }}\nb: x-${{ n }}-y\nc: ${{ flag }}\nd: ${{ ENV.MARIE_T_PORT | 1 }}\n",
    "l: ['${{ ENV.MARIE_TEST_PORT }}', '${{ CONTEXT.nope | [1, 2] }}']\n"],
    ids=range(11))
def test_load_config_and_expand_dict_equal_jax(text, monkeypatch):
    from marie_tpu.jaml import JAML as JJAML

    monkeypatch.setenv("MARIE_TEST_PORT", "8080")
    monkeypatch.setenv("MARIE_T_PORT", "5123")
    monkeypatch.setenv("TEST_FLOW_PORT", "5123")
    monkeypatch.delenv("MARIE_NOPE", raising=False)
    got = JAML.load_config(text, context=CONTEXT)
    want = JJAML.load_config(text, context=CONTEXT)
    assert _same(got, want)
    raw = JAML.load_config(text, substitute=False)
    assert _same(JAML.expand_dict(raw, CONTEXT), JJAML.expand_dict(raw, CONTEXT))


class PEncoder(JAMLCompatible):
    def __init__(self, dim: int = 16, name: str = "enc", inner=None):
        self.dim, self.name, self.inner = dim, name, inner


def test_construct_equals_jax():
    from marie_tpu.excepts import BadConfigSource as JBadConfigSource
    from marie_tpu.jaml import JAML as JJAML
    from marie_tpu.jaml import JAMLCompatible as JJAMLCompatible

    class JEncoder(JJAMLCompatible):
        def __init__(self, dim: int = 16, name: str = "enc", inner=None):
            self.dim, self.name, self.inner = dim, name, inner

    JEncoder.__name__ = "PEncoder"
    from marie_tpu.jaml import _Registry as JRegistry

    JRegistry.register(JEncoder)

    def state(obj):
        return (type(obj).__name__, obj.dim, obj.name,
                state(obj.inner) if isinstance(obj.inner, (PEncoder, JEncoder)) else obj.inner)

    cfgs = [{"jtype": "PEncoder", "with": {"dim": 32}},
            {"jtype": "PEncoder", "with": {"inner": {"jtype": "PEncoder", "with": {"dim": 8}}}},
            {"jtype": "PEncoder", "with": {"name": "x"}, "metas": {"n": 1}}]
    for cfg in cfgs:
        assert state(JAML.construct(cfg)) == state(JJAML.construct(cfg))
    assert JAML.construct({"a": 1}) == JJAML.construct({"a": 1}) == {"a": 1}
    assert state(PEncoder.load_config("jtype: PEncoder\nwith:\n  dim: 64\n")) == \
        state(JEncoder.load_config("jtype: PEncoder\nwith:\n  dim: 64\n"))
    assert JAML.deconstruct(PEncoder()) == JJAML.deconstruct(JEncoder()) == {"jtype": "PEncoder"}
    with pytest.raises(BadConfigSource):
        JAML.construct({"jtype": "DoesNotExist"})
    with pytest.raises(JBadConfigSource):
        JJAML.construct({"jtype": "DoesNotExist"})


def test_jtypes_of_the_jax_package_resolve_to_the_port():
    from marie_tpu_torch.executor import TextExtractionExecutorMock
    from marie_tpu_torch.jaml import resolve_jtype
    from marie_tpu_torch.serve.executors import BaseExecutor

    jax_name = "marie_tpu" + ".executor.TextExtractionExecutorMock"
    assert resolve_jtype(jax_name) is TextExtractionExecutorMock
    assert resolve_jtype("TextExtractionExecutorMock") is TextExtractionExecutorMock
    assert resolve_jtype("marie_tpu_torch.executor.TextExtractionExecutorMock") is \
        TextExtractionExecutorMock
    assert resolve_jtype("no.such.Thing") is None
    obj = JAML.construct({"jtype": jax_name}, expected_cls=BaseExecutor)
    assert isinstance(obj, TextExtractionExecutorMock)


# --- Flow from YAML ---------------------------------------------------------------

def _flow_state(flow):
    return {
        "port": flow.port, "protocols": list(flow.protocols), "prefetch": flow.prefetch,
        "deployments": {name: {"uses": dep.uses, "uses_with": dep.uses_with,
                               "needs": list(dep.needs), "replicas": dep.replicas,
                               "shards": dep.shards}
                        for name, dep in flow._deployments.items()},
        "graph": flow.build(),
    }


def test_service_config_loads_into_a_flow_equal_to_jax(monkeypatch):
    from marie_tpu.orchestrate.flow import Flow as JFlow
    from marie_tpu_torch.orchestrate.flow import Flow

    for env in ({}, {"MARIE_PORT": "53100", "MARIE_PREFETCH": "2"}):
        for k in ("MARIE_PORT", "MARIE_PREFETCH"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        path = str(REPO / "config" / "service" / "marie.yml")
        got = Flow.load_config(path, context=dict(os.environ))
        want = JFlow.load_config(path, context=dict(os.environ))
        assert _flow_state(got) == _flow_state(want)
        assert isinstance(got, Flow) and got.port == int(env.get("MARIE_PORT", 52000))


_BLOCKED_LOAD = r"""
import sys
for name in ("jax", "jaxlib", "flax", "yaml", "aiohttp", "pydantic", "PIL", "marie_tpu"):
    sys.modules[name] = None
from marie_tpu_torch.orchestrate.flow import Flow
from marie_tpu_torch.serve.runtimes.worker.request_handling import WorkerRequestHandler
flow = Flow.load_config("config/service/marie.yml")
handler = WorkerRequestHandler(uses=flow._deployments["extract_t"].uses, name="extract_t")
banned = ("jax", "yaml", "aiohttp", "pydantic", "PIL", "marie_tpu")
leaked = sorted(m for m in sys.modules if m.split(".")[0] in banned and sys.modules[m])
assert not leaked, leaked
print(sorted(flow._deployments), type(handler.executor).__module__)
"""


def test_service_config_loads_with_its_absent_packages_blocked():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", _BLOCKED_LOAD], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split() == ["['classify_t',", "'extract_t']",
                                  "marie_tpu_torch.executor.text_extraction_executor"]


def test_worker_builds_its_executor_from_yaml(tmp_path):
    from marie_tpu_torch.executor import TextExtractionExecutorMock
    from marie_tpu_torch.serve.runtimes.worker.request_handling import WorkerRequestHandler

    (tmp_path / "mod.py").write_text(
        "from marie_tpu_torch.serve.executors import BaseExecutor\n"
        "class YamlOnly(BaseExecutor):\n"
        "    def __init__(self, k=0, **kw):\n"
        "        super().__init__(**kw)\n"
        "        self.k = k\n")
    conf = tmp_path / "config.yml"
    conf.write_text("jtype: YamlOnly\npy_modules:\n  - mod.py\nwith:\n  k: 3\nmetas:\n  m: 1\n")
    for uses in (str(conf), conf.read_text(), {"jtype": "YamlOnly", "with": {"k": 3}}):
        ex = WorkerRequestHandler(uses=uses, name="y").executor
        assert type(ex).__name__ == "YamlOnly" and ex.k == 3
        assert ex.runtime_args.name == "y"
    ex = WorkerRequestHandler(uses={"jtype": "marie_tpu" + ".executor.TextExtractionExecutorMock"},
                              name="m").executor
    assert isinstance(ex, TextExtractionExecutorMock)


def test_worker_lets_an_executors_constructor_error_through(tmp_path, monkeypatch):
    """A dotted path that imports builds its class outside the lookup's
    ``except``: an ImportError the constructor raises (a library that does
    not load) reaches the caller as it was raised; a path that does not
    import is a BadConfigSource."""
    from marie_tpu_torch.excepts import BadConfigSource
    from marie_tpu_torch.serve.runtimes.worker.request_handling import WorkerRequestHandler

    (tmp_path / "failing_mod.py").write_text(
        "from marie_tpu_torch.serve.executors import BaseExecutor\n"
        "class Failing(BaseExecutor):\n"
        "    def __init__(self, **kw):\n"
        "        raise ImportError('the kernel library did not load')\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    with pytest.raises(ImportError, match="the kernel library did not load"):
        WorkerRequestHandler(uses="failing_mod.Failing", name="f")
    with pytest.raises(BadConfigSource):
        WorkerRequestHandler(uses="failing_mod.Absent", name="f")


# --- exports ----------------------------------------------------------------------

def _export_flows():
    from marie_tpu.executor.text_extraction_executor import TextExtractionExecutorMock as JMock
    from marie_tpu.orchestrate.flow import Flow as JFlow
    from marie_tpu_torch.executor.text_extraction_executor import TextExtractionExecutorMock
    from marie_tpu_torch.orchestrate.flow import Flow

    out = []
    for flow_cls, mock in ((Flow, TextExtractionExecutorMock), (JFlow, JMock)):
        out.append(flow_cls().add(uses=mock, name="a", replicas=2)
                   .add(uses="pkg.Mod", name="b", needs=["a"])
                   .add(uses=mock, name="c", needs=["a"], shards=2).needs_all(name="join"))
    return out


def _as_port(obj):
    """A JAX export with the port's own names: the image, the CLI command,
    the class paths and the accelerator."""
    if isinstance(obj, dict):
        return {("nvidia.com/gpu" if k == "google.com/tpu" else k): _as_port(v)
                for k, v in obj.items()}
    if isinstance(obj, list):
        if obj == ["python", "-m", "marie_tpu_cli"]:
            return ["python", "-m", "marie_tpu_torch.cli"]
        return [_as_port(v) for v in obj]
    if isinstance(obj, str):
        if obj == "marie-tpu:latest":
            return "marie-tpu-torch:latest"
        return obj.replace("marie_tpu" + ".", "marie_tpu_torch.")
    return obj


def test_exports_equal_jax_once_parsed():
    from marie_tpu.orchestrate import export as jexport
    from marie_tpu_torch.orchestrate import export

    port, jax_flow = _export_flows()
    for ns in ("marie", "prod"):
        got = port.to_kubernetes_yaml(namespace=ns)
        want = jax_flow.to_kubernetes_yaml(namespace=ns)
        assert list(yaml.safe_load_all(got)) == parser.load_all(got) == \
            _as_port(list(yaml.safe_load_all(want)))
    got, want = port.to_docker_compose_yaml(), jax_flow.to_docker_compose_yaml()
    assert yaml.safe_load(got) == parser.load(got) == _as_port(yaml.safe_load(want))
    assert export.to_mermaid(port) == jexport.to_mermaid(jax_flow)
    assert export.to_mermaid(port, "TD") == jexport.to_mermaid(jax_flow, "TD")


def test_schema_equals_jax_in_shape():
    from marie_tpu.schemas import get_full_schema as jschema
    from marie_tpu_torch.schemas import get_full_schema

    got, want = get_full_schema(), jschema()
    assert got["$schema"] == want["$schema"]
    assert set(got["definitions"]) == set(want["definitions"])
    assert got["definitions"]["Marie::Flow"]["properties"]["executors"] == \
        want["definitions"]["Marie::Flow"]["properties"]["executors"]
    assert set(got["definitions"]["Marie::Flow"]["properties"]["with"]["properties"]) == \
        set(want["definitions"]["Marie::Flow"]["properties"]["with"]["properties"])
