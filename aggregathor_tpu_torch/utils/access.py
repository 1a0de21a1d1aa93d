"""Filesystem access pre-checks.

Copy of ``aggregathor_tpu/utils/access.py``.  Parity with the
reference's ``tools.access.can_access`` (tools/access.py:42-79), which
validates dataset/checkpoint directories up front so a long run fails
at startup rather than mid-training.  Written fresh on ``os.access`` — the
kernel's answer to "can this process read/write this path", which also
honors ACLs and capabilities that raw uid/gid/mode-bit arithmetic (the
reference's approach) cannot see.
"""

import os


def can_access(path, read=False, write=False, recurse=False):
    """Check that ``path`` exists with the requested access.

    For directories, checks listability plus the requested access on every
    entry — descending into subdirectories only when ``recurse`` is set
    (same contract as the reference).  Returns False on any failure,
    including the path not existing; never raises.
    """
    mode = os.F_OK | (os.R_OK if read else 0) | (os.W_OK if write else 0)
    try:
        if not os.path.exists(path):
            return False
        if os.path.isdir(path):
            if not os.access(path, mode | os.X_OK):  # X on a dir = traversable
                return False
            for entry in os.scandir(path):
                if entry.is_dir(follow_symlinks=True):
                    if recurse and not can_access(entry.path, read, write, recurse):
                        return False
                elif not os.access(entry.path, mode):
                    return False
            return True
        return os.access(path, mode)
    except OSError:
        return False
