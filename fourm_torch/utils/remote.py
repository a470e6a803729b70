"""Remote shard I/O, PyTorch port (fourm_tpu/utils/remote.py; reference
fourm/utils/s3_utils.py:24-111).

  * `open_url(path)`: a binary file-like object with `.read()` for a local
    path, an http(s):// URL (urllib, streamed) or an s3:// object (boto3).
    data/datasets.py:_tar_samples streams remote tar shards through it into
    Python's tarfile.
  * `s3_upload` / `s3_download` for checkpoint sync (reference :24-63).

boto3 is imported only by the s3 paths; where it is absent (as on the
machine with the card) every s3:// path raises ImportError naming it.
"""

from __future__ import annotations

import os
import re
from typing import Optional, Tuple

_S3_RE = re.compile(r"^s3://([^/]+)/(.+)$")
HTTP_TIMEOUT = 60.0  # seconds a stalled http(s) read waits before it raises


def _require_boto3():
    try:
        import boto3  # type: ignore

        return boto3
    except ImportError as e:
        raise ImportError("s3:// paths need boto3 (reference s3_utils.py streams shards and "
                          "syncs checkpoints with it), which is not installed; use local or "
                          "http(s) paths") from e


def split_s3_path(path: str) -> Tuple[str, str]:
    m = _S3_RE.match(path)
    if not m:
        raise ValueError(f"not an s3 path: {path}")
    return m.group(1), m.group(2)


def make_s3_client(endpoint_url: Optional[str] = None):
    boto3 = _require_boto3()
    return boto3.client("s3", endpoint_url=endpoint_url or os.environ.get("S3_ENDPOINT"))


def open_url(path: str, endpoint_url: Optional[str] = None):
    """A shard opened for streaming reads: a local file, an http(s)://
    response (a read that waits HTTP_TIMEOUT s raises) or an s3:// object
    body."""
    if path.startswith("s3://"):
        bucket, key = split_s3_path(path)
        return make_s3_client(endpoint_url).get_object(Bucket=bucket, Key=key)["Body"]
    if path.startswith(("http://", "https://")):
        import urllib.request

        return urllib.request.urlopen(path, timeout=HTTP_TIMEOUT)
    return open(path, "rb")


def is_remote(path: str) -> bool:
    return path.startswith(("s3://", "http://", "https://"))


def s3_upload(local_path: str, s3_path: str, endpoint_url: Optional[str] = None):
    """Upload a file (reference save_on_s3, s3_utils.py:24-40)."""
    bucket, key = split_s3_path(s3_path)
    make_s3_client(endpoint_url).upload_file(local_path, bucket, key)


def s3_download(s3_path: str, local_path: str, endpoint_url: Optional[str] = None):
    """Download a file (reference download_from_s3, s3_utils.py:42-63)."""
    bucket, key = split_s3_path(s3_path)
    os.makedirs(os.path.dirname(os.path.abspath(local_path)), exist_ok=True)
    make_s3_client(endpoint_url).download_file(bucket, key, local_path)
