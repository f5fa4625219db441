"""Docker/OCI registry v2 client for executor images (port of
``marie_tpu/hub_docker.py``).

A wire implementation of the registry HTTP API on ``urllib`` (no docker
daemon): an executor bundle directory becomes a one-layer OCI image
(tar.gz layer, OCI config, manifest), pushed and pulled over plain HTTP:

* token auth: a 401 with ``WWW-Authenticate: Bearer realm=...`` starts
  docker's token exchange (GET realm?service&scope with basic
  credentials);
* blobs: ``HEAD /v2/<name>/blobs/<digest>`` for existence, then a
  two-step upload, ``POST /v2/<name>/blobs/uploads/`` and ``PUT
  ?digest=``;
* manifests: ``PUT/GET /v2/<name>/manifests/<tag>`` with the OCI
  manifest media type.

A pull extracts the layer back into a bundle directory, checking every
blob's digest and refusing tar members that leave it.  Both packages
write the same layer, config and manifest bytes for one bundle.
"""

import gzip
import hashlib
import io
import json
import os
import tarfile
import urllib.error
import urllib.parse
import urllib.request
from typing import Dict, Optional, Tuple

from marie_tpu_torch.logging_core import MarieLogger

MANIFEST_TYPE = "application/vnd.oci.image.manifest.v1+json"
CONFIG_TYPE = "application/vnd.oci.image.config.v1+json"
LAYER_TYPE = "application/vnd.oci.image.layer.v1.tar+gzip"


def _digest(data: bytes) -> str:
    return "sha256:" + hashlib.sha256(data).hexdigest()


class RegistryAuthError(RuntimeError):
    pass


class RegistryClient:
    """Minimal docker-registry-v2 / OCI-distribution client."""

    def __init__(
        self,
        base_url: str,
        username: Optional[str] = None,
        password: Optional[str] = None,
        token: Optional[str] = None,
        timeout: float = 30.0,
    ):
        self.base_url = base_url.rstrip("/")
        self.username = username
        self.password = password
        self._token = token
        self.timeout = timeout
        self.logger = MarieLogger("RegistryClient")

    # --- http plumbing -------------------------------------------------
    def _request(
        self,
        method: str,
        url: str,
        data: Optional[bytes] = None,
        headers: Optional[Dict[str, str]] = None,
        retry_auth: bool = True,
    ):
        req = urllib.request.Request(url, data=data, method=method)
        for k, v in (headers or {}).items():
            req.add_header(k, v)
        if self._token:
            req.add_header("Authorization", f"Bearer {self._token}")
        try:
            return urllib.request.urlopen(req, timeout=self.timeout)
        except urllib.error.HTTPError as ex:
            if ex.code == 401 and retry_auth:
                challenge = ex.headers.get("WWW-Authenticate", "")
                self._token = self._fetch_token(challenge)
                return self._request(
                    method, url, data=data, headers=headers, retry_auth=False
                )
            raise

    def _fetch_token(self, challenge: str) -> str:
        """Docker token dance: parse the Bearer challenge, GET the realm
        with service/scope and basic credentials."""
        if not challenge.lower().startswith("bearer"):
            raise RegistryAuthError(f"unsupported auth challenge: {challenge!r}")
        fields = {}
        for part in challenge[len("Bearer "):].split(","):
            k, _, v = part.strip().partition("=")
            fields[k] = v.strip('"')
        realm = fields.get("realm")
        if not realm:
            raise RegistryAuthError(f"challenge without realm: {challenge!r}")
        qs = {
            k: fields[k] for k in ("service", "scope") if fields.get(k)
        }
        url = realm + ("?" + urllib.parse.urlencode(qs) if qs else "")
        req = urllib.request.Request(url)
        if self.username is not None:
            import base64

            cred = base64.b64encode(
                f"{self.username}:{self.password or ''}".encode()
            ).decode()
            req.add_header("Authorization", f"Basic {cred}")
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                payload = json.loads(r.read().decode())
        except urllib.error.HTTPError as ex:
            raise RegistryAuthError(
                f"token request rejected ({ex.code})"
            ) from ex
        token = payload.get("token") or payload.get("access_token")
        if not token:
            raise RegistryAuthError("token endpoint returned no token")
        return token

    # --- blobs ----------------------------------------------------------
    def blob_exists(self, name: str, digest: str) -> bool:
        url = f"{self.base_url}/v2/{name}/blobs/{digest}"
        try:
            with self._request("HEAD", url):
                return True
        except urllib.error.HTTPError as ex:
            if ex.code == 404:
                return False
            raise

    def push_blob(self, name: str, data: bytes) -> str:
        digest = _digest(data)
        if self.blob_exists(name, digest):
            return digest
        # two-step (monolithic) upload
        with self._request(
            "POST", f"{self.base_url}/v2/{name}/blobs/uploads/"
        ) as r:
            location = r.headers.get("Location")
        if not location:
            raise RuntimeError("registry returned no upload Location")
        if location.startswith("/"):
            location = self.base_url + location
        sep = "&" if "?" in location else "?"
        put_url = f"{location}{sep}digest={urllib.parse.quote(digest)}"
        with self._request(
            "PUT", put_url, data=data,
            headers={"Content-Type": "application/octet-stream"},
        ):
            pass
        return digest

    def pull_blob(self, name: str, digest: str) -> bytes:
        url = f"{self.base_url}/v2/{name}/blobs/{digest}"
        with self._request("GET", url) as r:
            data = r.read()
        if _digest(data) != digest:
            raise RuntimeError(f"blob digest mismatch for {digest}")
        return data

    # --- manifests -------------------------------------------------------
    def push_manifest(self, name: str, tag: str, manifest: Dict) -> str:
        data = json.dumps(manifest, sort_keys=True).encode()
        with self._request(
            "PUT", f"{self.base_url}/v2/{name}/manifests/{tag}",
            data=data, headers={"Content-Type": MANIFEST_TYPE},
        ):
            pass
        return _digest(data)

    def pull_manifest(self, name: str, tag: str) -> Dict:
        with self._request(
            "GET", f"{self.base_url}/v2/{name}/manifests/{tag}",
            headers={"Accept": MANIFEST_TYPE},
        ) as r:
            return json.loads(r.read().decode())

    def tags(self, name: str) -> list:
        with self._request(
            "GET", f"{self.base_url}/v2/{name}/tags/list"
        ) as r:
            return json.loads(r.read().decode()).get("tags", [])


# --- executor bundle <-> OCI image -----------------------------------------
def _bundle_layer(bundle_dir: str) -> bytes:
    """Deterministic tar.gz of the bundle tree (fixed mtimes/owners so
    the layer digest is reproducible for identical content)."""
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w") as tar:
        for root, dirs, files in os.walk(bundle_dir):
            dirs.sort()
            for fname in sorted(files):
                full = os.path.join(root, fname)
                arc = os.path.relpath(full, bundle_dir)
                info = tarfile.TarInfo(arc)
                info.size = os.path.getsize(full)
                info.mtime = 0
                info.uid = info.gid = 0
                with open(full, "rb") as f:
                    tar.addfile(info, f)
    return gzip.compress(buf.getvalue(), mtime=0)


def push_executor_image(
    client: RegistryClient,
    bundle_dir: str,
    name: str,
    tag: str = "latest",
    labels: Optional[Dict[str, str]] = None,
) -> Tuple[str, Dict]:
    """Bundle dir -> one-layer OCI image -> registry.  Returns
    (manifest_digest, manifest)."""
    layer = _bundle_layer(bundle_dir)
    layer_digest = client.push_blob(name, layer)
    config = {
        "architecture": "amd64",
        "os": "linux",
        "config": {"Labels": {"ai.marietpu.executor": name, **(labels or {})}},
        "rootfs": {"type": "layers", "diff_ids": [layer_digest]},
    }
    config_bytes = json.dumps(config, sort_keys=True).encode()
    config_digest = client.push_blob(name, config_bytes)
    manifest = {
        "schemaVersion": 2,
        "mediaType": MANIFEST_TYPE,
        "config": {
            "mediaType": CONFIG_TYPE,
            "digest": config_digest,
            "size": len(config_bytes),
        },
        "layers": [
            {
                "mediaType": LAYER_TYPE,
                "digest": layer_digest,
                "size": len(layer),
            }
        ],
    }
    digest = client.push_manifest(name, tag, manifest)
    return digest, manifest


def pull_executor_image(
    client: RegistryClient, name: str, tag: str, dest_dir: str
) -> str:
    """Registry image -> extracted bundle directory.  Verifies blob
    digests; refuses path-traversing tar members."""
    manifest = client.pull_manifest(name, tag)
    os.makedirs(dest_dir, exist_ok=True)
    for layer in manifest.get("layers", []):
        data = client.pull_blob(name, layer["digest"])
        raw = gzip.decompress(data)
        with tarfile.open(fileobj=io.BytesIO(raw)) as tar:
            for member in tar.getmembers():
                target = os.path.realpath(os.path.join(dest_dir, member.name))
                if not target.startswith(os.path.realpath(dest_dir) + os.sep):
                    raise RuntimeError(
                        f"tar member escapes bundle dir: {member.name}"
                    )
            tar.extractall(dest_dir, filter="data")  # members checked above
    return dest_dir
