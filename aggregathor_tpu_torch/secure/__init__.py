"""Submission integrity: the train -> sign -> serve chain of custody.

Counterpart of ``aggregathor_tpu/secure``, in three pieces:

- ``submit``   per-(worker, step) HMAC authentication of gradient
  submissions: row digests in the step on the rows' device, sign and
  verify on the host one call behind, reject-and-name through the
  forensics ledger;
- ``masking``  bucket-level pairwise additive masking, cancelled exactly
  (mod 2^64) inside bucket and hier group means;
- ``custody``  signed lineage manifests beside every checkpoint, verified
  by the training restore and the guardian's rollback.
"""

from .custody import ChainOfCustody, manifest_path  # noqa: F401
from .masking import GroupMasking, enable_masking, masked_group_mean  # noqa: F401
from .submit import (  # noqa: F401
    DIGEST_LANES,
    SubmissionAuthenticator,
    digest_to_bytes,
    row_digest,
    tamper_row,
)
