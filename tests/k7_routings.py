"""Rows an expert for the tests of K7 (kernels/moe_experts.py): routings of
64 experts that reach each width of the kernel (8, 16, 32, 64, 128 rows)
and its edges, shared by the CPU tests of the plain version
(test_torch_dsv2.py) and the card tests of the kernel
(test_torch_dsv2_card.py). Imports no JAX.

- served_decode: a decode step as the DeepSeek-V2 engine serves it, 32 rows
  x 6 assignments over 43 experts, one expert holding all 32 rows;
- one_expert: every assignment in one expert, 300 rows (chunks of 128, 128
  and 44);
- boundaries: experts of exactly 1, 8, 9, 16, 17, 64, 65, 128 and 129 rows,
  an empty expert between some of them;
- empty_between: two touched experts of 5 and 7 rows around an empty one,
  12 rows in all (a wide box reaches before row 0);
- all_touched: all 64 experts, 1-12 rows each;
- served_prefill: a prefill as the engine serves it, 584 rows x 6,
  concentrated: 31 experts, one holding every row, the next 546.
"""
import torch

EXPERTS = 64
CASES = ("served_decode", "one_expert", "boundaries", "empty_between", "all_touched",
         "served_prefill")
BOUNDARIES = (1, 8, 9, 16, 17, 64, 65, 128, 129)
PREFILL_TAIL = (584, 400, 300, 240, 200, 170, 150, 130, 129, 128, 100, 80, 65, 64, 50, 40,
                33, 30, 17, 16, 9, 8, 5, 3, 2, 1, 1, 1, 1, 1)


def counts(case: str, seed: int = 0) -> list:
    """Rows of each of the 64 experts in `case`; `seed` places them."""
    g = torch.Generator().manual_seed(seed)
    c = [0] * EXPERTS
    if case == "served_decode":
        top = int(torch.randint(0, EXPERTS, (1,), generator=g))
        others = [e for e in torch.randperm(EXPERTS, generator=g).tolist() if e != top][:42]
        c[top] = 32
        for e in others:
            c[e] = 1
        for k in torch.randint(0, len(others), (192 - 32 - len(others),), generator=g).tolist():
            c[others[k]] += 1
    elif case == "one_expert":
        c[int(torch.randint(0, EXPERTS, (1,), generator=g))] = 300
    elif case == "boundaries":
        for e, n in zip((0, 2, 3, 5, 6, 8, 9, 11, 12), BOUNDARIES):
            c[e] = n
    elif case == "empty_between":
        c[30], c[32] = 5, 7
    elif case == "all_touched":
        c = torch.randint(1, 13, (EXPERTS,), generator=g).tolist()
    elif case == "served_prefill":
        rows = [584 * 6 - sum(PREFILL_TAIL), *PREFILL_TAIL]
        for e, n in zip(torch.randperm(EXPERTS, generator=g).tolist(), rows):
            c[e] = n
    else:
        raise ValueError(case)
    return c


def offsets(c: list, device="cpu") -> torch.Tensor:
    """The int32 offsets (E + 1,) of rows sorted by expert."""
    return torch.tensor([0] + torch.tensor(c).cumsum(0).tolist(), dtype=torch.int32,
                        device=device)
