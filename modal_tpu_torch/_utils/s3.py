"""A minimal S3-compatible client: list, get and put, signed with AWS SigV4
(port of modal_tpu/_utils/s3.py).

It backs CloudBucketMount (reference py/modal/cloud_bucket_mount.py, where
the worker mounts the bucket; here the container syncs the bucket prefix
into the mount path before user code and writes changed files back at
exit). It talks to AWS S3 or any S3-compatible endpoint (R2, GCS interop,
minio, the tests' emulator), anonymously when no credentials are set. The
signing is the standard library's (hmac, hashlib) and the transport
aiohttp's: no boto.
"""

from __future__ import annotations

import datetime
import hashlib
import hmac
import os
import urllib.parse
import xml.etree.ElementTree as ET
from dataclasses import dataclass
from typing import Optional

import aiohttp


@dataclass
class S3Config:
    bucket: str
    endpoint_url: Optional[str] = None  # None = AWS S3 virtual-host style
    region: str = "us-east-1"
    access_key: Optional[str] = None
    secret_key: Optional[str] = None
    session_token: Optional[str] = None

    @staticmethod
    def from_env(bucket: str, endpoint_url: Optional[str]) -> "S3Config":
        return S3Config(
            bucket=bucket,
            endpoint_url=endpoint_url,
            region=os.environ.get("AWS_REGION", "us-east-1"),
            access_key=os.environ.get("AWS_ACCESS_KEY_ID"),
            secret_key=os.environ.get("AWS_SECRET_ACCESS_KEY"),
            session_token=os.environ.get("AWS_SESSION_TOKEN"),
        )

    def base_url(self) -> str:
        if self.endpoint_url:
            return f"{self.endpoint_url.rstrip('/')}/{self.bucket}"
        return f"https://{self.bucket}.s3.{self.region}.amazonaws.com"


def _sign(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def _sigv4_headers(
    cfg: S3Config, method: str, url: str, payload_sha256: str, extra: Optional[dict] = None
) -> dict:
    """AWS Signature Version 4 (the standard derivation; no request body is
    buffered here — caller passes the payload hash)."""
    parsed = urllib.parse.urlsplit(url)
    now = datetime.datetime.now(datetime.timezone.utc)
    amz_date = now.strftime("%Y%m%dT%H%M%SZ")
    datestamp = now.strftime("%Y%m%d")
    headers = {"host": parsed.netloc, "x-amz-date": amz_date, "x-amz-content-sha256": payload_sha256}
    if cfg.session_token:
        headers["x-amz-security-token"] = cfg.session_token
    if extra:
        headers.update({k.lower(): v for k, v in extra.items()})
    if not cfg.access_key or not cfg.secret_key:
        # anonymous: emulated/public endpoints accept unsigned requests
        return {k: v for k, v in headers.items() if k != "host"}
    signed_names = ";".join(sorted(headers))
    canonical_headers = "".join(f"{k}:{headers[k]}\n" for k in sorted(headers))
    canonical_query = "&".join(
        f"{urllib.parse.quote(k, safe='')}={urllib.parse.quote(v, safe='')}"
        for k, v in sorted(urllib.parse.parse_qsl(parsed.query, keep_blank_values=True))
    )
    # the URL path is ALREADY percent-encoded (callers quote the key when
    # building it); re-quoting would double-encode (%20 -> %2520) and break
    # the signature for any key with spaces/'+'/non-ASCII
    canonical_request = "\n".join(
        [method, parsed.path or "/", canonical_query, canonical_headers, signed_names, payload_sha256]
    )
    scope = f"{datestamp}/{cfg.region}/s3/aws4_request"
    string_to_sign = "\n".join(
        ["AWS4-HMAC-SHA256", amz_date, scope, hashlib.sha256(canonical_request.encode()).hexdigest()]
    )
    k = _sign(_sign(_sign(_sign(f"AWS4{cfg.secret_key}".encode(), datestamp), cfg.region), "s3"), "aws4_request")
    signature = hmac.new(k, string_to_sign.encode(), hashlib.sha256).hexdigest()
    headers["authorization"] = (
        f"AWS4-HMAC-SHA256 Credential={cfg.access_key}/{scope}, "
        f"SignedHeaders={signed_names}, Signature={signature}"
    )
    return {k: v for k, v in headers.items() if k != "host"}


EMPTY_SHA256 = hashlib.sha256(b"").hexdigest()


class S3Client:
    def __init__(self, cfg: S3Config):
        self.cfg = cfg

    async def list_keys(self, prefix: str = "") -> list[str]:
        """ListObjectsV2 with continuation paging."""
        keys: list[str] = []
        token = ""
        async with aiohttp.ClientSession() as session:
            while True:
                query = {"list-type": "2"}
                if prefix:
                    query["prefix"] = prefix
                if token:
                    query["continuation-token"] = token
                url = f"{self.cfg.base_url()}?{urllib.parse.urlencode(sorted(query.items()))}"
                headers = _sigv4_headers(self.cfg, "GET", url, EMPTY_SHA256)
                async with session.get(url, headers=headers) as resp:
                    resp.raise_for_status()
                    text = await resp.text()
                root = ET.fromstring(text)
                ns = root.tag.split("}")[0] + "}" if root.tag.startswith("{") else ""
                for contents in root.findall(f"{ns}Contents"):
                    key_el = contents.find(f"{ns}Key")
                    if key_el is not None and key_el.text:
                        keys.append(key_el.text)
                truncated = root.findtext(f"{ns}IsTruncated") == "true"
                token = root.findtext(f"{ns}NextContinuationToken") or ""
                if not truncated or not token:
                    return keys

    async def get_object(self, key: str) -> bytes:
        url = f"{self.cfg.base_url()}/{urllib.parse.quote(key)}"
        headers = _sigv4_headers(self.cfg, "GET", url, EMPTY_SHA256)
        async with aiohttp.ClientSession() as session:
            async with session.get(url, headers=headers) as resp:
                resp.raise_for_status()
                return await resp.read()

    def put_object_sync(self, key: str, data: bytes) -> None:
        """Blocking PUT via urllib — for exit-time paths where the event
        loop is mid-cancellation and aiohttp awaits can be interrupted or
        starved (container shutdown write-back)."""
        import urllib.request

        url = f"{self.cfg.base_url()}/{urllib.parse.quote(key)}"
        payload_hash = hashlib.sha256(data).hexdigest()
        headers = _sigv4_headers(self.cfg, "PUT", url, payload_hash)
        req = urllib.request.Request(url, data=data, method="PUT", headers=headers)
        with urllib.request.urlopen(req, timeout=60) as resp:
            if resp.status >= 300:
                raise OSError(f"PUT {key} failed: HTTP {resp.status}")

    async def put_object(self, key: str, data, payload_sha256: Optional[str] = None) -> None:
        """PUT an object. `data` may be bytes or a binary file object (file
        objects stream — pass `payload_sha256` so the body isn't buffered
        just to hash it). Single-PUT only: callers with >5 GB objects need
        the multipart path (blob_utils) — S3 caps single PUTs there."""
        url = f"{self.cfg.base_url()}/{urllib.parse.quote(key)}"
        if payload_sha256 is None:
            if not isinstance(data, (bytes, bytearray)):
                raise ValueError("file-object uploads require payload_sha256")
            payload_sha256 = hashlib.sha256(data).hexdigest()
        headers = _sigv4_headers(self.cfg, "PUT", url, payload_sha256)
        async with aiohttp.ClientSession() as session:
            async with session.put(url, data=data, headers=headers) as resp:
                resp.raise_for_status()
