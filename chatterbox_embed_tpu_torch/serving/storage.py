"""Cloud storage adapters: Cloudflare R2 (S3 API via boto3) and Firestore;
the port's own copy of `chatterbox_embed_tpu/serving/storage.py` (standard
library only; reference: storage/r2_storage.py:35-182,
storage/bucket_resolver.py:13-97).

Both SDKs are optional: importable -> real clients from env config;
missing -> a local-filesystem emulation under $CHATTERBOX_LOCAL_STORAGE so
the worker pipeline runs end-to-end in hermetic environments.
"""
from __future__ import annotations

import base64
import json
import logging
import os
import re
import tempfile
from pathlib import Path
from typing import Any, Dict, Optional

logger = logging.getLogger(__name__)

R2_DEFAULT_BUCKET = "minstraly-storage"


# ---------------------------------------------------------------------------
# bucket resolution (reference: storage/bucket_resolver.py)
# ---------------------------------------------------------------------------

def is_r2_bucket(bucket: Optional[str]) -> bool:
    if not bucket:
        return False
    return bucket == R2_DEFAULT_BUCKET or bucket.startswith("r2://")


def resolve_bucket_name(bucket: Optional[str] = None) -> str:
    if bucket:
        return bucket.removeprefix("r2://")
    return os.getenv("R2_BUCKET_NAME", R2_DEFAULT_BUCKET)


def voice_id_slug(name: str) -> str:
    slug = re.sub(r"[^a-z0-9]+", "_", name.lower()).strip("_")
    return f"voice_{slug}" if slug else "voice_unnamed"


# ---------------------------------------------------------------------------
# R2 / S3
# ---------------------------------------------------------------------------

def _r2_client():
    import boto3  # type: ignore
    endpoint = os.getenv("R2_ENDPOINT") or (
        f"https://{os.environ['R2_ACCOUNT_ID']}.r2.cloudflarestorage.com")
    return boto3.client(
        "s3", endpoint_url=endpoint,
        aws_access_key_id=os.environ["R2_ACCESS_KEY"],
        aws_secret_access_key=os.environ["R2_SECRET"],
    )


def _local_root() -> Path:
    root = Path(os.getenv("CHATTERBOX_LOCAL_STORAGE")
                or os.path.join(tempfile.gettempdir(), "chatterbox_storage"))
    root.mkdir(parents=True, exist_ok=True)
    return root


def _ascii_metadata(meta: Dict[str, str]) -> Dict[str, str]:
    """S3 metadata must be ASCII; base64-wrap anything else
    (reference: r2_storage.py metadata encoding)."""
    out = {}
    for k, v in (meta or {}).items():
        v = str(v)
        if v.isascii():
            out[k] = v
        else:
            out[f"{k}-b64"] = base64.b64encode(v.encode()).decode()
    return out


def upload_to_r2(data: bytes, dest_path: str, bucket: Optional[str] = None,
                 content_type: str = "application/octet-stream",
                 metadata: Optional[Dict[str, str]] = None) -> str:
    bucket = resolve_bucket_name(bucket)
    try:
        client = _r2_client()
        client.put_object(Bucket=bucket, Key=dest_path, Body=data,
                          ContentType=content_type,
                          Metadata=_ascii_metadata(metadata or {}))
        public_base = os.getenv("R2_PUBLIC_BASE", f"https://{bucket}.example.com")
        return f"{public_base}/{dest_path}"
    except (ImportError, KeyError):
        target = _local_root() / bucket / dest_path
        target.parent.mkdir(parents=True, exist_ok=True)
        target.write_bytes(data)
        logger.info("local-storage emulation: wrote %s", target)
        return str(target)


def download_from_r2(key: str, bucket: Optional[str] = None) -> bytes:
    bucket = resolve_bucket_name(bucket)
    try:
        client = _r2_client()
        return client.get_object(Bucket=bucket, Key=key)["Body"].read()
    except (ImportError, KeyError):
        return (_local_root() / bucket / key).read_bytes()


# ---------------------------------------------------------------------------
# Firestore
# ---------------------------------------------------------------------------

class _LocalFirestore:
    """File-backed stand-in exposing the tiny Firestore surface the worker
    uses (collection().document().set/update)."""

    class _Doc:
        def __init__(self, path: Path):
            self.path = path

        def set(self, data: Dict[str, Any], merge: bool = False):
            cur = {}
            if merge and self.path.exists():
                cur = json.loads(self.path.read_text())
            cur.update(data)
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self.path.write_text(json.dumps(cur, default=str))

        update = set

        def get(self):
            class Snap:
                exists = self.path.exists()
                def to_dict(inner):
                    return json.loads(self.path.read_text())
            return Snap()

    class _Coll:
        def __init__(self, path: Path):
            self.path = path

        def document(self, doc_id: str):
            return _LocalFirestore._Doc(self.path / f"{doc_id}.json")

    def collection(self, name: str):
        return self._Coll(_local_root() / "firestore" / name)


def init_firestore_client():
    """(reference: storage/r2_storage.py:156-182) — service-account JSON from
    RUNPOD_SECRET_Firebase, ADC fallback, local emulation last."""
    secret = os.getenv("RUNPOD_SECRET_Firebase")
    try:
        from google.cloud import firestore  # type: ignore
        if secret:
            from google.oauth2 import service_account  # type: ignore
            info = json.loads(secret)
            creds = service_account.Credentials.from_service_account_info(info)
            return firestore.Client(credentials=creds, project=info["project_id"])
        return firestore.Client()
    except ImportError:
        logger.warning("google-cloud-firestore unavailable; local emulation")
        return _LocalFirestore()
