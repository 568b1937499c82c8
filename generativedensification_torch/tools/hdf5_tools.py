"""HDF5 shard split / merge (reference ``tools/hdf5_split_merge.py``).

The 1.4 TB Gobjaverse dataset ships as parts; ``split`` shards a big file
by scene groups, ``merge`` concatenates shards back (threaded copies)."""

from __future__ import annotations

import sys
from concurrent.futures import ThreadPoolExecutor


def split(src: str, n_parts: int, out_prefix: str | None = None):
    import h5py

    out_prefix = out_prefix or src.rsplit(".", 1)[0]
    with h5py.File(src, "r") as f:
        scenes = sorted(f.keys())
        per = -(-len(scenes) // n_parts)
        for p in range(n_parts):
            part_scenes = scenes[p * per: (p + 1) * per]
            out = f"{out_prefix}.part{p}.h5"
            with h5py.File(out, "w") as fo:
                for s in part_scenes:
                    f.copy(s, fo)
            print(f"[split] {out}: {len(part_scenes)} scenes")


def merge(parts: list[str], out: str, workers: int = 4):
    import h5py

    with h5py.File(out, "w") as fo:
        def copy_part(path):
            with h5py.File(path, "r") as f:
                names = sorted(f.keys())
                # h5py handles are not thread-safe for writes; lock via GIL
                # by copying in the main thread after parallel readouts
                return path, names

        with ThreadPoolExecutor(workers) as ex:
            listed = list(ex.map(copy_part, parts))
        for path, names in listed:
            with h5py.File(path, "r") as f:
                for s in names:
                    f.copy(s, fo)
            print(f"[merge] {path}: {len(names)} scenes")
    print(f"[merge] wrote {out}")


def main():
    if len(sys.argv) < 3:
        print(
            "usage: ... hdf5_tools split SRC.h5 N_PARTS\n"
            "       ... hdf5_tools merge OUT.h5 PART1.h5 PART2.h5 ..."
        )
        raise SystemExit(1)
    if sys.argv[1] == "split":
        split(sys.argv[2], int(sys.argv[3]))
    elif sys.argv[1] == "merge":
        merge(sys.argv[3:], sys.argv[2])
    else:
        raise SystemExit(f"unknown command {sys.argv[1]}")


if __name__ == "__main__":
    main()
