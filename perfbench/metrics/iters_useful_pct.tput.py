"""Of the iterations the batches of the window ran (codewords x the batch's
largest iteration count, since a batch runs until its slowest codeword is
done), the share its codewords needed (the sum of their iteration counts),
%, from the program's outputs."""


def read(run):
    if not run.iters:
        return None
    need = sum(int(it.sum()) for it in run.iters)
    ran = sum(it.numel() * int(it.max()) for it in run.iters)
    return 100.0 * need / ran if ran else None
