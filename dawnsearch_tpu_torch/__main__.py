"""CLI: `python -m dawnsearch_tpu_torch` runs a node; `... track` runs the
tracker; `... sidecar` embeds WARC files into sidecar files offline.

Port of dawnsearch_tpu/__main__.py. Config comes from DawnSearch.toml +
DAWNSEARCH_* env vars (config.rs:42-73), with a few direct CLI overrides.
The reference package's `migrate` and `eval-quality` subcommands are not
ported (ROADMAP.md Queue 1, item 14).
"""

from __future__ import annotations

import argparse
import os


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="dawnsearch_tpu_torch",
        description="distributed semantic search node (PyTorch + CUDA)")
    parser.add_argument("--config", default="DawnSearch.toml",
                        help="TOML config path (default: DawnSearch.toml)")
    parser.add_argument("--web", action="store_true",
                        help="serve the search UI (overrides config)")
    parser.add_argument("--udp", action="store_true",
                        help="join the P2P network (overrides config)")
    parser.add_argument("--index-cc", action="store_true",
                        help="ingest Common Crawl (overrides config)")
    parser.add_argument("--data-dir", default=None)
    parser.add_argument("--listen", default=None,
                        help="web listen address host:port")
    sub = parser.add_subparsers(dest="command")
    # a subparser option reusing a parent dest overwrites the parent's
    # value with the subparser default, so shared flags get their own
    # sub_* dest and merge after parsing (as the reference does)
    track = sub.add_parser("track", help="run the rendezvous tracker "
                                         "(reference: dawntrack)")
    track.add_argument("--listen", dest="sub_listen", default=None,
                       help="tracker bind address (default 0.0.0.0:7230)")
    track.add_argument("--external-address", default=None,
                       help="advertise this address for loopback "
                            "announcers (dawntrack.rs:77-82)")
    sidecar = sub.add_parser(
        "sidecar", help="offline WARC -> embedding sidecar files, or bulk "
                        "index load (reference: src/index/warc.rs)")
    sidecar.add_argument("warcs", nargs="+",
                         help="WARC files, URLs, or Common Crawl "
                              "crawl-data/... keys to embed, or .npz "
                              "sidecars with --load")
    sidecar.add_argument("--load", action="store_true",
                         help="bulk-load .npz sidecars into the data dir "
                              "instead of embedding WARCs")
    sidecar.add_argument("--config", dest="sub_config", default=None)
    args = parser.parse_args(argv)
    config_path = getattr(args, "sub_config", None) or args.config

    if args.command == "track":
        from dawnsearch_tpu_torch.net.tracker import Tracker
        Tracker(args.sub_listen or "0.0.0.0:7230",
                external_address=args.external_address).run_forever()
        return 0

    from dawnsearch_tpu_torch.config import Config

    cfg = Config.load(config_path)
    if args.data_dir:
        cfg.data_dir = args.data_dir
    if args.command == "sidecar":
        return _sidecar(cfg, args.warcs, args.load)

    from dawnsearch_tpu_torch.node import DawnNode

    if args.web:
        cfg.web = True
    if args.udp:
        cfg.udp = True
    if args.index_cc:
        cfg.index_cc = True
    if args.listen:
        cfg.web_listen_address = args.listen
    print(cfg.summary(), flush=True)
    node = DawnNode(cfg).start()
    node.run_forever()
    return 0


def _sidecar(cfg, warcs: list[str], load: bool) -> int:
    """`sidecar`: embed each WARC into `<name>.sidecar.npz` beside it (a
    remote one in the working directory) with the node's encoder, or with
    --load bulk-load sidecars into cfg.data_dir's store and index."""
    from dawnsearch_tpu_torch.ingest.sidecar import (index_sidecars,
                                                     load_sidecar, open_warc,
                                                     write_sidecar)
    from dawnsearch_tpu_torch.node import (check_config, make_encoder,
                                           make_index_factory)
    check_config(cfg)
    if load:
        from dawnsearch_tpu_torch.index.provider import SearchProvider
        # the index is as wide as the sidecars' embeddings
        dim = int(load_sidecar(warcs[0])[0].shape[1])
        provider = SearchProvider(
            data_dir=cfg.data_dir, dim=dim, index_dtype=cfg.index_dtype,
            max_pages=cfg.index_capacity,
            index_factory=make_index_factory(cfg, dim=dim),
            device=cfg.device)
        n = index_sidecars(provider, warcs)
        provider.shutdown()
        print(f"indexed {n} pages into {cfg.data_dir}")
        return 0
    enc = make_encoder(cfg)
    for w in warcs:
        name, src = open_warc(w)
        # local files keep their directory (dir1/x.warc.gz and
        # dir2/x.warc.gz must not collide); remote ones land in the
        # working directory under their basename
        base = w if os.path.exists(w) else name
        out = base.rsplit(".warc", 1)[0] + ".sidecar.npz"
        n = write_sidecar(src, enc.encode, out)
        print(f"{w}: {n} pages -> {out}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
