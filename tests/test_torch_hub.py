"""The port's executor hub (``hub.py``), its OCI registry client
(``hub_docker.py``), the worker's ``hub://`` uses and the ``hub`` CLI,
against the JAX package's: a bundle pushed by either package's hub
installs through the other's with the same ``index.json`` entries,
sha256 and manifest; references parse and versions sort alike; the
remote HTTP registry and the OCI registry (token auth, bad credentials,
skipped blobs, traversal) serve both packages' clients; the hub
subcommands parse as JAX's parser parses them."""

import asyncio
import filecmp
import json
import os
import threading
from http.server import ThreadingHTTPServer

import pytest

from marie_tpu_torch import hub as thub
from marie_tpu_torch import hub_docker as tdocker
from marie_tpu_torch.hub import ExecutorHub, parse_hub_ref


def _executor_pkg(tmp_path, base_pkg: str, text: str, dirname: str = "myexec"):
    """An executor bundle directory: a config.yml naming its class and the
    module defining it (built on ``base_pkg``'s BaseExecutor)."""
    pkg = tmp_path / dirname
    pkg.mkdir(exist_ok=True)
    (pkg / "exec.py").write_text(
        f"from {base_pkg}.serve.executors import BaseExecutor\n"
        f"from {base_pkg}.serve.executors.decorators import requests\n"
        "class HubEcho(BaseExecutor):\n"
        "    @requests(on='/hubecho')\n"
        "    def go(self, docs, **kw):\n"
        f"        [setattr(d, 'text', d.text + ':{text}') for d in docs]\n"
        "        return docs\n")
    (pkg / "config.yml").write_text("jtype: HubEcho\npy_modules:\n  - exec.py\n")
    return str(pkg)


def _same_tree(a, b) -> bool:
    cmp = filecmp.dircmp(a, b)
    return not (cmp.left_only or cmp.right_only or cmp.diff_files) and all(
        _same_tree(os.path.join(a, d), os.path.join(b, d)) for d in cmp.common_dirs)


def test_parse_hub_ref_and_semver_as_jax():
    from marie_tpu import hub as jhub

    for ref in ("hub://echo", "hub://echo:1.2.0", "hub://echo:latest", "hub://a.b-c_d:0.1.0-rc1",
                "hub://x:1+build.5"):
        assert parse_hub_ref(ref) == jhub.parse_hub_ref(ref), ref
    for bad in ("echo:1.0", "hub://", "hub://a:b:c", "hub://a/b"):
        with pytest.raises(ValueError):
            parse_hub_ref(bad)
        with pytest.raises(ValueError):
            jhub.parse_hub_ref(bad)
    versions = ["0.10.0", "0.9.0", "0.2.1", "1.0.0-rc1", "1.0.0", "1.0.0+b2", "0.10.0-alpha"]
    assert sorted(versions, key=thub._semver_key) == sorted(versions, key=jhub._semver_key)


@pytest.mark.parametrize("pusher", ["jax", "port"])
def test_bundle_installs_through_the_other_package(tmp_path, pusher):
    """A bundle pushed by one package's hub installs through the other's:
    the same index entries and sha256, the same manifest, the same tree."""
    from marie_tpu.hub import ExecutorHub as JExecutorHub

    hub_dir = str(tmp_path / "hub")
    hubs = {"jax": JExecutorHub, "port": ExecutorHub}
    puller = "port" if pusher == "jax" else "jax"
    pkg = _executor_pkg(tmp_path, "marie_tpu_torch", "v1")
    src = hubs[pusher](hub_dir=hub_dir, install_dir=str(tmp_path / "src-inst"))
    for v in ("0.9.0", "0.10.0"):
        src.push(pkg, "myexec", v, metadata={"description": "echo: it says v1", "tags": 2})
    dst = hubs[puller](hub_dir=hub_dir, install_dir=str(tmp_path / "dst-inst"))
    index = json.load(open(os.path.join(hub_dir, "index.json")))
    assert dst._load_index() == src._load_index() == index
    assert dst.versions("myexec") == src.versions("myexec") == ["0.9.0", "0.10.0"]
    assert dst.list() == src.list()
    installed = dst.resolve("hub://myexec")
    assert installed.endswith(os.path.join("myexec-0.10.0", "myexec"))
    marker = open(os.path.join(os.path.dirname(installed), ".sha256")).read()
    assert marker == index["myexec"]["0.10.0"]["sha256"]
    assert _same_tree(installed, pkg)
    assert src.resolve("hub://myexec:0.10.0") != installed
    assert dst.manifest("myexec") == src.manifest("myexec")
    got = dst.manifest("myexec", "0.9.0")
    assert got["name"] == "myexec" and got["version"] == "0.9.0" and got["tags"] == 2
    assert got["description"] == "echo: it says v1" and isinstance(got["pushed_at"], float)
    # a cached resolve does not extract again; a tampered bundle fails
    stamp = os.path.getmtime(os.path.join(os.path.dirname(installed), ".sha256"))
    assert dst.resolve("hub://myexec") == installed
    assert os.path.getmtime(os.path.join(os.path.dirname(installed), ".sha256")) == stamp
    with open(os.path.join(hub_dir, "myexec-0.9.0.tar.gz"), "ab") as fp:
        fp.write(b"tamper")
    with pytest.raises(ValueError, match="digest mismatch"):
        dst.pull("myexec", "0.9.0")


@pytest.fixture
def bundle_registry():
    """The JAX suite's fake ``/v1`` bundle registry, in this process."""
    from tests.unit.test_hub_registry import _FakeRegistry

    _FakeRegistry.bundles = {}
    server = ThreadingHTTPServer(("127.0.0.1", 0), _FakeRegistry)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{server.server_address[1]}", _FakeRegistry
    server.shutdown()
    server.server_close()


def test_remote_registry_push_pull(tmp_path, bundle_registry):
    """The port pushes to the remote registry; a fresh hub of each package
    resolves the reference through it, with the same digest."""
    from marie_tpu.hub import ExecutorHub as JExecutorHub

    url, registry = bundle_registry
    pkg = _executor_pkg(tmp_path, "marie_tpu_torch", "remote")
    publisher = ExecutorHub(hub_dir=str(tmp_path / "pub"), registry_url=url)
    publisher.push(pkg, "remoteexec", "1.0.0")
    body, digest = registry.bundles[("remoteexec", "1.0.0")]
    assert digest == publisher._load_index()["remoteexec"]["1.0.0"]["sha256"]
    got = []
    for cls, name in ((ExecutorHub, "port"), (JExecutorHub, "jax")):
        consumer = cls(hub_dir=str(tmp_path / f"c-{name}"),
                       install_dir=str(tmp_path / f"i-{name}"), registry_url=url)
        installed = consumer.resolve("hub://remoteexec:1.0.0")
        assert os.path.exists(os.path.join(installed, "exec.py"))
        assert consumer.versions("remoteexec") == ["1.0.0"]
        got.append((consumer._load_index()["remoteexec"]["1.0.0"]["sha256"],
                    consumer.manifest("remoteexec")))
    assert got[0] == got[1] and got[0][0] == digest
    assert got[0][1]["name"] == "remoteexec"


def test_worker_loads_hub_reference(tmp_path, monkeypatch, bundle_registry):
    """``uses="hub://..."`` resolves through ``MARIE_HUB_REGISTRY`` into the
    directories of ``MARIE_HUB_DIR`` / ``MARIE_HUB_INSTALL`` and serves."""
    from marie_tpu_torch.serve.runtimes.worker.request_handling import WorkerRequestHandler
    from marie_tpu_torch.types.docs import Document, DocumentArray
    from marie_tpu_torch.types.request import DataRequest

    url, _ = bundle_registry
    pkg = _executor_pkg(tmp_path, "marie_tpu_torch", "fromhub", dirname="hubworker")
    ExecutorHub(hub_dir=str(tmp_path / "pub"), registry_url=url).push(pkg, "hubworker", "1.0.0")
    monkeypatch.setenv("MARIE_HUB_REGISTRY", url)
    monkeypatch.setenv("MARIE_HUB_DIR", str(tmp_path / "hub"))
    monkeypatch.setenv("MARIE_HUB_INSTALL", str(tmp_path / "installs"))
    handler = WorkerRequestHandler(uses="hub://hubworker:latest", name="hubexec")
    assert type(handler.executor).__name__ == "HubEcho"
    assert os.path.isdir(tmp_path / "installs" / "hubworker-1.0.0" / "hubworker")
    req = DataRequest.from_docs(DocumentArray([Document(text="x")]), endpoint="/hubecho")
    assert asyncio.run(handler.process_data([req])).docs[0].text == "x:fromhub"
    with pytest.raises(FileNotFoundError):
        WorkerRequestHandler(uses="hub://nothing-like-this")


@pytest.fixture
def oci_registry():
    """The JAX suite's fake OCI registry (token auth), in this process."""
    from tests.integration.test_hub_docker import FakeRegistry

    FakeRegistry.blobs, FakeRegistry.manifests, FakeRegistry.require_auth = {}, {}, True
    server = ThreadingHTTPServer(("127.0.0.1", 0), FakeRegistry)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{server.server_address[1]}", FakeRegistry
    server.shutdown()
    server.server_close()


def _oci_bundle(tmp_path):
    b = tmp_path / "bundle"
    (b / "exec").mkdir(parents=True, exist_ok=True)
    (b / "config.yml").write_text("jtype: BaseExecutor\n")
    (b / "exec" / "app.py").write_text("print('executor')\n")
    return str(b)


def test_oci_round_trip_with_auth_pulled_by_jax(oci_registry, tmp_path):
    from marie_tpu import hub_docker as jdocker

    url, registry = oci_registry
    client = tdocker.RegistryClient(url, username="ci", password="s3cret")
    digest, manifest = tdocker.push_executor_image(client, _oci_bundle(tmp_path), "marie/extract",
                                                   tag="1.0.0", labels={"version": "1.0.0"})
    assert digest.startswith("sha256:") and client.tags("marie/extract") == ["1.0.0"]
    # both packages write the same image bytes for one bundle
    jblobs = dict(registry.blobs)
    jdigest, jmanifest = jdocker.push_executor_image(
        jdocker.RegistryClient(url, username="ci", password="s3cret"), _oci_bundle(tmp_path),
        "marie/extract", tag="1.0.1", labels={"version": "1.0.0"})
    assert (jdigest, jmanifest) == (digest, manifest) and registry.blobs == jblobs
    for mod, name in ((jdocker, "jax"), (tdocker, "port")):
        dest = tmp_path / f"pulled-{name}"
        mod.pull_executor_image(mod.RegistryClient(url, username="ci", password="s3cret"),
                                "marie/extract", "1.0.0", str(dest))
        assert (dest / "config.yml").read_text() == "jtype: BaseExecutor\n"
        assert (dest / "exec" / "app.py").exists()
    assert _same_tree(tmp_path / "pulled-jax", tmp_path / "pulled-port")


def test_oci_bad_credentials_skipped_blobs_and_traversal(oci_registry, tmp_path):
    import gzip
    import hashlib
    import io
    import tarfile

    url, registry = oci_registry
    with pytest.raises(tdocker.RegistryAuthError):
        tdocker.push_executor_image(tdocker.RegistryClient(url, username="ci", password="no"),
                                    _oci_bundle(tmp_path), "marie/x")
    client = tdocker.RegistryClient(url, username="ci", password="s3cret")
    bundle = _oci_bundle(tmp_path)
    _, m1 = tdocker.push_executor_image(client, bundle, "marie/extract", "1.0.0")
    n_blobs = len(registry.blobs)
    _, m2 = tdocker.push_executor_image(client, bundle, "marie/extract", "1.0.1")
    assert len(registry.blobs) == n_blobs and m1["layers"] == m2["layers"]
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w") as tar:
        info = tarfile.TarInfo("../../evil.txt")
        info.size = 4
        tar.addfile(info, io.BytesIO(b"boom"))
    layer = gzip.compress(buf.getvalue(), mtime=0)
    client.push_blob("marie/evil", layer)
    client.push_manifest("marie/evil", "1", {"schemaVersion": 2, "layers": [
        {"digest": "sha256:" + hashlib.sha256(layer).hexdigest(), "size": len(layer)}]})
    with pytest.raises(RuntimeError, match="escapes"):
        tdocker.pull_executor_image(client, "marie/evil", "1", str(tmp_path / "out"))
    assert not (tmp_path / "evil.txt").exists()


def test_hub_cli_as_jax(tmp_path, monkeypatch, capsys):
    """The ``hub`` subcommands parse as JAX's parser parses them, and push,
    list, versions, manifest and pull print what the JAX CLI prints on
    the same hub."""
    import marie_tpu_cli
    from marie_tpu.parsers import build_parser as jparser

    from marie_tpu_torch import cli
    from marie_tpu_torch.parsers import build_parser

    for argv in (["hub", "push", "d", "--name", "n", "--version", "1.0.0"], ["hub", "push", "d"],
                 ["hub", "pull", "n:1"], ["hub", "versions", "n"], ["hub", "manifest", "n:1"],
                 ["hub", "list"]):
        assert vars(build_parser().parse_args(argv)) == vars(jparser().parse_args(argv)), argv
    monkeypatch.setenv("MARIE_HUB_DIR", str(tmp_path / "hub"))
    monkeypatch.setenv("MARIE_HUB_INSTALL", str(tmp_path / "install"))
    pkg = _executor_pkg(tmp_path, "marie_tpu_torch", "cli")
    assert cli.main(["hub", "push", pkg, "--name", "myexec", "--version", "1.2.3"]) == 0
    assert capsys.readouterr().out.startswith("pushed myexec:1.2.3 -> ")
    outs = []
    for main in (cli.main, marie_tpu_cli.main):
        assert main(["hub", "list"]) == 0 and main(["hub", "versions", "myexec"]) == 0
        assert main(["hub", "pull", "myexec:1.2.3"]) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and "myexec:1.2.3  sha256:" in outs[0]
    assert os.path.exists(os.path.join(outs[0].splitlines()[-1], "config.yml"))
    for main in (cli.main, marie_tpu_cli.main):
        assert main(["hub", "manifest", "myexec"]) == 0
    m = capsys.readouterr().out
    half = len(m) // 2
    assert m[:half] == m[half:] and json.loads(m[:half])["version"] == "1.2.3"
    monkeypatch.delenv("MARIE_REGISTRY", raising=False)
    with pytest.raises(SystemExit, match="MARIE_REGISTRY"):
        cli.main(["hub", "pull", "docker://marie/x:1"])
