"""Executor hub (port of ``marie_tpu/hub.py``): package, publish, resolve
and install executor bundles.

Two stores behind one API:

* a local or shared directory (the default): bundles and ``index.json``;
* a remote HTTP registry (``registry_url``): ``GET/PUT
  /v1/bundles/<name>/<version>`` and ``GET /v1/index/<name>``, on
  ``urllib``, so any static file server satisfies it.

References read ``hub://name``, ``hub://name:1.2.0`` or
``hub://name:latest``; versions sort by semver (0.10.0 > 0.9.0), an
install checks the bundle's sha256 against the index, and a resolve hits
the local install cache unless the digest changed upstream.  A bundle's
``manifest.yml`` goes through the port's YAML reader and writer
(:mod:`marie_tpu_torch.jaml.parser`; PyYAML is not on the card's
machine), keys sorted as PyYAML's ``safe_dump`` sorts them: either
package reads the other's bundles.  The directories default to
``~/.marie/hub`` and ``~/.marie/executors`` (``MARIE_HUB_DIR``,
``MARIE_HUB_INSTALL``; ``MARIE_HUB_REGISTRY`` names the registry).
"""

import hashlib
import io
import json
import os
import re
import shutil
import tarfile
import time
import urllib.error
import urllib.request
from typing import Any, Dict, List, Optional, Tuple

from marie_tpu_torch.jaml import parser as yaml_parser
from marie_tpu_torch.logging_core import MarieLogger

_DEFAULT_HUB = os.path.expanduser("~/.marie/hub")
_DEFAULT_INSTALL = os.path.expanduser("~/.marie/executors")

_REF_RE = re.compile(r"^hub://(?P<name>[A-Za-z0-9_.-]+?)(?::(?P<version>[^:]+))?$")


def parse_hub_ref(ref: str) -> Tuple[str, Optional[str]]:
    """``hub://name[:version]`` -> (name, version|None)."""
    m = _REF_RE.match(ref)
    if not m:
        raise ValueError(f"not a hub reference: {ref!r}")
    version = m.group("version")
    return m.group("name"), (None if version in (None, "latest") else version)


def _semver_key(v: str):
    parts = []
    for piece in re.split(r"[.+-]", v):
        parts.append((0, int(piece)) if piece.isdigit() else (1, piece))
    return parts


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fp:
        for chunk in iter(lambda: fp.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


class ExecutorHub:
    def __init__(
        self,
        hub_dir: Optional[str] = None,
        registry_url: Optional[str] = None,
        install_dir: Optional[str] = None,
        timeout: float = 30.0,
    ):
        self.hub_dir = hub_dir or os.environ.get("MARIE_HUB_DIR", _DEFAULT_HUB)
        registry_url = registry_url or os.environ.get("MARIE_HUB_REGISTRY")
        self.registry_url = registry_url.rstrip("/") if registry_url else None
        self.install_dir = install_dir or os.environ.get(
            "MARIE_HUB_INSTALL", _DEFAULT_INSTALL
        )
        self.timeout = timeout
        os.makedirs(self.hub_dir, exist_ok=True)
        self.logger = MarieLogger("hub")

    # --- index ------------------------------------------------------------
    def _index_path(self) -> str:
        return os.path.join(self.hub_dir, "index.json")

    def _load_index(self) -> Dict[str, Dict[str, Dict[str, Any]]]:
        try:
            with open(self._index_path()) as fp:
                return json.load(fp)
        except (OSError, json.JSONDecodeError):
            return {}

    def _save_index(self, index) -> None:
        with open(self._index_path(), "w") as fp:
            json.dump(index, fp, indent=1, sort_keys=True)

    # --- push ---------------------------------------------------------------
    def push(
        self,
        executor_dir: str,
        name: str,
        version: str = "0.1.0",
        metadata: Optional[Dict[str, Any]] = None,
    ) -> str:
        """Bundle an executor directory and publish it (local hub dir, and
        the remote registry when configured)."""
        if not os.path.isdir(executor_dir):
            raise FileNotFoundError(executor_dir)
        manifest = {
            "name": name,
            "version": version,
            "pushed_at": time.time(),
            **(metadata or {}),
        }
        bundle_path = os.path.join(self.hub_dir, f"{name}-{version}.tar.gz")
        with tarfile.open(bundle_path, "w:gz") as tar:
            tar.add(executor_dir, arcname=name)
            data = yaml_parser.dump(dict(sorted(manifest.items()))).encode()
            info = tarfile.TarInfo("manifest.yml")
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))
        digest = _sha256_file(bundle_path)
        index = self._load_index()
        index.setdefault(name, {})[version] = {
            "sha256": digest,
            "pushed_at": manifest["pushed_at"],
            "bundle": os.path.basename(bundle_path),
        }
        self._save_index(index)

        if self.registry_url:
            with open(bundle_path, "rb") as fp:
                body = fp.read()
            req = urllib.request.Request(
                f"{self.registry_url}/v1/bundles/{name}/{version}",
                data=body,
                method="PUT",
                headers={"X-Bundle-Sha256": digest},
            )
            urllib.request.urlopen(req, timeout=self.timeout).close()
            self.logger.info(f"pushed {name}:{version} -> registry")
        self.logger.info(f"pushed {name}:{version} -> {bundle_path}")
        return bundle_path

    # --- resolution -----------------------------------------------------------
    def versions(self, name: str) -> List[str]:
        """Known versions, semver-sorted ascending (local + registry)."""
        found = set(self._load_index().get(name, {}))
        for f in os.listdir(self.hub_dir):
            if f.startswith(f"{name}-") and f.endswith(".tar.gz"):
                found.add(f[len(name) + 1 : -len(".tar.gz")])
        if self.registry_url:
            try:
                with urllib.request.urlopen(
                    f"{self.registry_url}/v1/index/{name}", timeout=self.timeout
                ) as resp:
                    found.update(json.load(resp).keys())
            except urllib.error.URLError:
                pass
        return sorted(found, key=_semver_key)

    def _latest_version(self, name: str) -> str:
        versions = self.versions(name)
        if not versions:
            raise FileNotFoundError(f"{name} not in hub {self.hub_dir}")
        return versions[-1]

    def _registry_digest(self, name: str, version: str) -> Optional[str]:
        if not self.registry_url:
            return None
        try:
            with urllib.request.urlopen(
                f"{self.registry_url}/v1/index/{name}", timeout=self.timeout
            ) as resp:
                return json.load(resp).get(version, {}).get("sha256")
        except urllib.error.URLError:
            return None

    def _fetch_bundle(self, name: str, version: str) -> str:
        """Ensure the bundle exists locally (downloading when needed);
        returns its path, verifying sha256 against the index."""
        bundle_path = os.path.join(self.hub_dir, f"{name}-{version}.tar.gz")
        expected = self._registry_digest(name, version) or (
            self._load_index().get(name, {}).get(version, {}).get("sha256")
        )
        if not os.path.exists(bundle_path):
            if not self.registry_url:
                raise FileNotFoundError(
                    f"{name}:{version} not in hub {self.hub_dir}"
                )
            url = f"{self.registry_url}/v1/bundles/{name}/{version}"
            with urllib.request.urlopen(url, timeout=self.timeout) as resp:
                data = resp.read()
            with open(bundle_path, "wb") as fp:
                fp.write(data)
            index = self._load_index()
            index.setdefault(name, {})[version] = {
                "sha256": _sha256_file(bundle_path),
                "pushed_at": time.time(),
                "bundle": os.path.basename(bundle_path),
            }
            self._save_index(index)
        if expected:
            actual = _sha256_file(bundle_path)
            if actual != expected:
                raise ValueError(
                    f"{name}:{version} digest mismatch "
                    f"(expected {expected[:12]}…, got {actual[:12]}…)"
                )
        return bundle_path

    # --- pull -----------------------------------------------------------------
    def pull(self, name: str, version: Optional[str] = None,
             target_dir: Optional[str] = None) -> str:
        """Install an executor bundle; returns the installed package dir."""
        version = version or self._latest_version(name)
        bundle_path = self._fetch_bundle(name, version)
        target_dir = target_dir or self.install_dir
        install_root = os.path.join(target_dir, f"{name}-{version}")
        marker = os.path.join(install_root, ".sha256")
        digest = _sha256_file(bundle_path)
        if os.path.exists(marker) and open(marker).read().strip() == digest:
            return os.path.join(install_root, name)  # cached install
        if os.path.isdir(install_root):
            shutil.rmtree(install_root)
        os.makedirs(install_root, exist_ok=True)
        with tarfile.open(bundle_path, "r:gz") as tar:
            tar.extractall(install_root, filter="data")
        with open(marker, "w") as fp:
            fp.write(digest)
        return os.path.join(install_root, name)

    def resolve(self, ref: str) -> str:
        """``hub://name[:version|latest]`` -> installed executor dir."""
        name, version = parse_hub_ref(ref)
        return self.pull(name, version)

    def manifest(self, name: str, version: Optional[str] = None) -> Dict[str, Any]:
        version = version or self._latest_version(name)
        bundle_path = self._fetch_bundle(name, version)
        with tarfile.open(bundle_path, "r:gz") as tar:
            fp = tar.extractfile("manifest.yml")
            return yaml_parser.load(fp.read().decode()) if fp else {}

    def list(self) -> List[Dict[str, Any]]:
        out = []
        index = self._load_index()
        for f in sorted(os.listdir(self.hub_dir)):
            if not f.endswith(".tar.gz"):
                continue
            stem = f[: -len(".tar.gz")]
            name, _, version = stem.rpartition("-")
            entry = {"name": name, "version": version, "bundle": f}
            meta = index.get(name, {}).get(version)
            if meta:
                entry["sha256"] = meta["sha256"]
            out.append(entry)
        return out
