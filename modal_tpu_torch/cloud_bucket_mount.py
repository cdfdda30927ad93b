"""CloudBucketMount: an S3, R2 or GCS bucket mounted into containers (port
of modal_tpu/cloud_bucket_mount.py).

Reference: py/modal/cloud_bucket_mount.py `_CloudBucketMount`, a descriptor;
the container realizes it (runtime/bucket_mounts.py: the bucket prefix
synced into the mount path before user code, changed files written back at
exit). A function takes it in `volumes=` beside Volumes; its definition
carries it as JSON in `cloud_bucket_mounts`.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Optional

from .secret import _Secret


@dataclass
class CloudBucketMount:
    """Descriptor for mounting a cloud bucket at a container path."""

    bucket_name: str
    bucket_endpoint_url: Optional[str] = None  # None = AWS S3; set for R2/GCS interop
    key_prefix: Optional[str] = None
    secret: Optional[_Secret] = None
    oidc_auth_role_arn: Optional[str] = None
    read_only: bool = False
    requester_pays: bool = False

    def __post_init__(self) -> None:
        if self.key_prefix and not self.key_prefix.endswith("/"):
            raise ValueError("key_prefix must end with '/'")
        if self.requester_pays and self.secret is None:
            raise ValueError("requester_pays requires a secret with credentials")

    def serialize(self) -> str:
        return json.dumps(
            {
                "bucket_name": self.bucket_name,
                "bucket_endpoint_url": self.bucket_endpoint_url,
                "key_prefix": self.key_prefix,
                "read_only": self.read_only,
                "requester_pays": self.requester_pays,
            }
        )
