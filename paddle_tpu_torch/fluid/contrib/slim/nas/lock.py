"""contrib/slim/nas/lock.py (ref) — advisory file locks the LightNAS
server used; generic and kept real. Port of
paddle_tpu/fluid/contrib/slim/nas/lock.py."""
import fcntl
import os

__all__ = ["lock", "unlock"]


def lock(file):
    """Block until an exclusive flock on ``file`` is held."""
    if os.name == "posix":
        fcntl.flock(file, fcntl.LOCK_EX)


def unlock(file):
    if os.name == "posix":
        fcntl.flock(file, fcntl.LOCK_UN)
