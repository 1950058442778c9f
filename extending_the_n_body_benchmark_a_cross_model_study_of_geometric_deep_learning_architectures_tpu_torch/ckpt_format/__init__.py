"""The file formats of an orbax checkpoint directory, read and written
without orbax, tensorstore or zstandard: :mod:`.zstd` (RFC 8878 frames),
:mod:`.crc32c`, :mod:`.ocdbt` (tensorstore's key-value store) and
:mod:`.zarr2` (zarr v2 arrays on it).  ``train/checkpoint.py`` builds the
``orbax`` backend on them.  Numpy and the standard library only."""
