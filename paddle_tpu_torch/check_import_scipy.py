"""ref: python/paddle/check_import_scipy.py — Windows DLL diagnosis for
scipy imports; same contract (no-op unless the import fails on nt)."""

__all__ = ["check_import_scipy"]


def check_import_scipy(OsName):
    if OsName == "nt":
        try:
            import scipy.io  # noqa: F401
        except ImportError as e:
            if "DLL load failed" in str(e):
                raise ImportError(
                    str(e) + "\nplease download visual C++ "
                    "Redistributable from https://www.microsoft.com/"
                    "en-us/download/details.aspx?id=48145"
                )
    return
