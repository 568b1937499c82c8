"""Dataset download utilities.

Equivalents of the reference's ``tools/download_dataset.py`` (HF-hub
folder fetch of the released LaRa/GenerativeDensification data + ckpts,
reference `tools/download_dataset.py:1-59`) and
``tools/download_objaverse.py`` (URL-list tar downloader,
`tools/download_objaverse.py:1-51`).  Import of ``huggingface_hub`` is
deferred so the module loads in zero-egress environments; the CLI fails
with a clear message instead of an ImportError at import time.
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import os
import urllib.request


HF_DATASET_REPO = "stnamjef/gobjaverse"
HF_CKPT_REPO = "stnamjef/GenerativeDensification"


def download_hf_folder(repo_id: str, local_dir: str, allow_patterns=None,
                       repo_type: str = "dataset") -> str:
    """Fetch a folder from the HuggingFace hub (resumable snapshot)."""
    try:
        from huggingface_hub import snapshot_download
    except ImportError as e:  # pragma: no cover - env-dependent
        raise RuntimeError(
            "huggingface_hub is not installed (zero-egress environment?). "
            "Install it or fetch the data on a networked machine."
        ) from e
    return snapshot_download(
        repo_id=repo_id,
        repo_type=repo_type,
        local_dir=local_dir,
        allow_patterns=allow_patterns,
    )


def download_url_list(urls, out_dir: str, workers: int = 8,
                      skip_existing: bool = True) -> list[str]:
    """Parallel URL downloader (the objaverse tar shards ship as one URL
    per line).  Returns the list of local paths."""
    os.makedirs(out_dir, exist_ok=True)

    def fetch(url: str) -> str:
        name = url.rstrip("/").split("/")[-1]
        dst = os.path.join(out_dir, name)
        if skip_existing and os.path.exists(dst):
            return dst
        tmp = dst + ".part"
        urllib.request.urlretrieve(url, tmp)
        os.replace(tmp, dst)
        return dst

    with cf.ThreadPoolExecutor(max_workers=workers) as ex:
        return list(ex.map(fetch, urls))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    hf = sub.add_parser("hf", help="snapshot a HF-hub repo folder")
    hf.add_argument("--repo", default=HF_DATASET_REPO)
    hf.add_argument("--repo-type", default="dataset")
    hf.add_argument("--out", required=True)
    hf.add_argument("--patterns", nargs="*", default=None)

    ul = sub.add_parser("urls", help="download a URL list file")
    ul.add_argument("--list", required=True, help="file with one URL/line")
    ul.add_argument("--out", required=True)
    ul.add_argument("--workers", type=int, default=8)

    a = p.parse_args(argv)
    if a.cmd == "hf":
        path = download_hf_folder(a.repo, a.out, a.patterns, a.repo_type)
        print(path)
    else:
        with open(a.list) as f:
            urls = [ln.strip() for ln in f if ln.strip()]
        got = download_url_list(urls, a.out, a.workers)
        print(f"downloaded {len(got)} files -> {a.out}")


if __name__ == "__main__":
    main()
