"""Seconds to move a tensor through a mesh call (leader to follower) and
back (follower to leader) over the pipe between two ranks of the port's
mesh (chatterbox_embed_tpu_torch/parallel/mesh.py), in pieces of
`mesh.PIECE` bytes and as one whole message (PIECE set above the size).

    python3 scripts/torch_mesh_transfer.py [--mb 16,64] [--whole-mb 16,64] [--device cpu]

Two ranks on the first card (or on `--device`); one line a (size, mode).
"""
import argparse
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def _set_piece(n: int) -> None:
    from chatterbox_embed_tpu_torch.parallel import mesh
    mesh.PIECE = n


def _zeros(nbytes: int, device) -> torch.Tensor:
    return torch.zeros(nbytes // 4, device=device)


def _numel(x: torch.Tensor) -> int:
    return x.numel()


def main() -> None:
    from chatterbox_embed_tpu_torch import parallel
    from chatterbox_embed_tpu_torch.parallel import mesh as mesh_lib
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mb", default="16,64,1024", help="sizes sent in pieces, MB")
    ap.add_argument("--whole-mb", default="16,64", help="sizes sent as one message, MB")
    ap.add_argument("--device", default=None, help="device of both ranks (default the card)")
    args = ap.parse_args()
    device = torch.device(args.device or "cuda")
    mesh = parallel.make_dp_mesh(2, device=device)
    piece = mesh_lib.PIECE
    runs = [("pieces", int(x)) for x in args.mb.split(",") if x] + [
        ("whole", int(x)) for x in args.whole_mb.split(",") if x]
    try:
        for mode, mb in runs:
            n = mb << 20
            mesh.call_all(_set_piece, piece if mode == "pieces" else 2 * n + (1 << 20))
            x = _zeros(n, mesh.device)
            t0 = time.time()
            got = mesh.call_all(_numel, x)
            call_s = time.time() - t0
            t0 = time.time()
            back = mesh.call_all(_zeros, n, mesh.device)
            reply_s = time.time() - t0
            assert got == [n // 4] * 2 and back[1].numel() == n // 4
            print(f"[transfer] mode={mode} mb={mb} call_s={call_s:.3f} reply_s={reply_s:.3f} "
                  f"piece_bytes={mesh_lib.PIECE} device={device}", flush=True)
    finally:
        parallel.shutdown()


if __name__ == "__main__":
    main()
