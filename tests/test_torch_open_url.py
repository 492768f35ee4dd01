"""The port's `utils.open_url` (a copy of the JAX package's, reference
`dnnlib/util.py:382-477`) with an injected fetch, as tests/test_io_utils.py
drives the JAX one: local paths and `file://` URLs, retries, the
Content-Disposition name, the atomic md5-keyed cache and its hits (the same
file name as the JAX package's, so one cache serves both), Google Drive's
virus-check nag and quota page.  Nothing is fetched over a network."""

import hashlib
import os

import pytest

from pasta_gan_tpu.utils import open_url as jax_open_url
from pasta_gan_tpu_torch.utils import open_url


def _no_fetch(url):
    raise AssertionError(f"fetch must not be called: {url}")


def test_local_paths_and_file_urls(tmp_path):
    p = tmp_path / "net.pkl"
    p.write_bytes(b"local")
    assert open_url(str(p), return_filename=True) == str(p)
    with open_url(str(p), _fetch=_no_fetch) as f:
        assert f.read() == b"local"
    assert open_url(f"file://{p}", return_filename=True) == str(p)
    with open_url(f"file://{p}", _fetch=_no_fetch) as f:
        assert f.read() == b"local"


def test_download_cache_and_google_drive(tmp_path):
    cache = str(tmp_path / "cache")
    url = "https://example.com/weights.pkl"
    md5 = hashlib.md5(url.encode()).hexdigest()
    calls = {"n": 0}

    def flaky(u):
        calls["n"] += 1
        if calls["n"] < 3:
            raise IOError("transient")
        return b"PAYLOAD" * 2000, {"Content-Disposition": 'attachment; filename="net.pkl"'}

    assert open_url(url, cache_dir=cache, _fetch=flaky).read(7) == b"PAYLOAD" and calls["n"] == 3
    assert os.listdir(cache) == [md5 + "_net.pkl"]
    # a cache hit fetches nothing, and the JAX package finds the same file
    with open_url(url, cache_dir=cache, _fetch=_no_fetch) as f:
        assert f.read(7) == b"PAYLOAD"
    path = open_url(url, cache_dir=cache, _fetch=_no_fetch, return_filename=True)
    assert path == jax_open_url(url, cache_dir=cache, _fetch=_no_fetch, return_filename=True)
    assert path == os.path.join(cache, md5 + "_net.pkl")

    with pytest.raises(IOError, match="down"):
        open_url("https://example.com/other", cache_dir=cache, num_attempts=2,
                 _fetch=lambda u: (_ for _ in ()).throw(IOError("down")))

    real = b"REALDATA" * 1500

    def gdrive(u):
        if "export=download" not in u:
            return b'<a href="/uc?export=download&confirm=t&id=abc">download</a>', {"Set-Cookie": "download_warning_x=1"}
        return real, {}

    assert open_url("https://drive.google.com/uc?id=abc", cache_dir=cache, cache=False, _fetch=gdrive).read() == real
    with pytest.raises(IOError, match="quota exceeded"):
        open_url("https://drive.google.com/uc?id=q", cache_dir=cache, cache=False, num_attempts=1,
                 _fetch=lambda u: (b"<title>Google Drive - Quota exceeded</title>", {}))
    # a URL with no Content-Disposition is cached under its own sanitized name
    open_url("https://example.com/a b.pkl", cache_dir=cache, _fetch=lambda u: (b"x" * 10000, {}))
    md5b = hashlib.md5(b"https://example.com/a b.pkl").hexdigest()
    assert f"{md5b}_https___example.com_a_b.pkl" in os.listdir(cache)
    assert not [n for n in os.listdir(cache) if n.startswith("tmp_")]
