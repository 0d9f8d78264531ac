"""Does torch's row sum of a [C, W] f32 product on the card depend on C?

The scanned tracker's slice correlator sums [C, W] products with
``.sum(-1)``; a channel-sharded run sums [C / n, W]. This probe sums the
rows of [32, W] products whole and in row blocks of 16, 8 and 4 and
reports, for each W, whether the blocks' sums equal the whole's bit for
bit. Run on a card: ``python tools/port_rowsum_probe.py``.
"""
import torch


def main() -> None:
    torch.manual_seed(0)
    for w in (2046 + 64, 2048, 4096):
        a = torch.randn(32, w, device="cuda")
        b = torch.randn(32, w, device="cuda")
        full = (a * b).sum(-1)
        for rows in (16, 8, 4):
            parts = torch.cat([(a[i:i + rows] * b[i:i + rows]).sum(-1)
                               for i in range(0, 32, rows)])
            print(f"W={w} rows={rows}: equal={torch.equal(parts, full)} "
                  f"max diff={float((parts - full).abs().max()):.3e}")


if __name__ == "__main__":
    main()
