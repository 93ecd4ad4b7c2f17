"""The benchmark's inputs, made from the run's seed.

Frozen copies of the program's smoke test's data makers (`mutate`,
`write_fasta` and the pair), so that a later change
to the program cannot change what the benchmark feeds it, and the maker of
a large species-structured collection drawn straight into 2-bit words on
the device.  Every genome spec is a dict from a configuration file,
updated by the traffic file's "genomes" entry.
"""
from __future__ import annotations

import pathlib
from typing import List, Sequence, Tuple

import numpy as np


def numpy_rng(seed: int, *stream: int) -> np.random.Generator:
    """The run's host generator (any whole seed; `stream` keeps the draws
    of separate purposes apart)."""
    return np.random.default_rng([int(seed) & (2 ** 64 - 1), *stream])


def mutate(rng, codes, rate):
    """A copy of codes with a `rate` share of positions substituted."""
    out = codes.copy()
    hit = rng.random(out.size) < rate
    out[hit] = (out[hit] + rng.integers(1, 4, int(hit.sum()))) % 4
    return out


def write_fasta(path, name, codes, rng):
    """codes as a FASTA of a few records (two random cuts) with three
    N-runs of 10-99 nt, 80 nt per line."""
    text = np.frombuffer(b"ACGT", np.uint8)[codes]
    for start in rng.integers(0, text.size - 200, 3):
        text[start:start + int(rng.integers(10, 100))] = ord("N")
    cuts = np.sort(rng.integers(1, text.size, 2))
    with open(path, "wb") as f:
        for r, rec in enumerate(np.split(text, cuts)):
            f.write(f">{name}_record{r}\n".encode())
            full = rec.size // 80 * 80
            lines = np.full((rec.size // 80, 81), ord("\n"), np.uint8)
            lines[:, :80] = rec[:full].reshape(-1, 80)
            f.write(lines.tobytes())
            if full < rec.size:
                f.write(rec[full:].tobytes() + b"\n")
    return str(path)


def write_genomes(dirpath: pathlib.Path, seed: int, spec: dict) -> List[str]:
    """Two genomes of spec["length_nt"] nt as FASTA files: genome 0 uniform
    random, genome 1 a spec["substitution"] substituted copy of it."""
    rng = numpy_rng(seed, 1)
    base = rng.integers(0, 4, int(spec["length_nt"])).astype(np.uint8)
    codes = [base, mutate(rng, base, float(spec["substitution"]))]
    return [write_fasta(dirpath / f"genome{i}.fa", f"genome{i}", c, rng)
            for i, c in enumerate(codes)]


# --- species-structured collections drawn on the device ---------------------

def species_sizes(genomes: int, species: int, exponent: float) -> np.ndarray:
    """Members of each species, a Zipf law: size_r ~ r ** -exponent for
    rank r = 1..species, rounded down, at least 1, the total `genomes`
    (the largest remainders take the rest).  The same for every seed."""
    if species > genomes:
        raise ValueError("more species than genomes")
    w = np.arange(1, species + 1, dtype=np.float64) ** -float(exponent)
    share = genomes * w / w.sum()
    sizes = np.maximum(1, np.floor(share)).astype(np.int64)
    rest = genomes - int(sizes.sum())
    order = np.argsort(-(share - np.floor(share)), kind="stable")
    sizes[order[:max(rest, 0)]] += 1
    for _ in range(-rest):       # the floor of 1 took more than the rounding
        sizes[np.argmax(sizes)] -= 1
    return sizes


def _as_i32(x):
    """int64 values in [0, 2**32) -> the int32 of the same bits."""
    import torch
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def device_collection(spec: dict, seed: int, words: int, device,
                      batch: int = 256) -> Tuple[object, np.ndarray]:
    """spec["count"] genomes of spec["length_nt"] codes, packed 16 codes a
    32-bit word, least significant first (`words` a genome, the codes past
    the length random).  Genomes fall into spec["species"] species of
    Zipf sizes (species_sizes); each species has a random root, and each
    member is the root with a share of its sites, drawn uniformly from
    spec["substitution"] ([low, high]) a member, substituted by another
    base.  Members are shuffled over the collection.  Roots, sites and
    bases come from a torch.Generator on `device`, the rates and the
    order from the host's.  Returns ((G, words) int32 tensor, species id
    of each genome)."""
    import torch
    dev = torch.device(device)
    g, n = int(spec["count"]), int(spec["length_nt"])
    if 16 * words < n:
        raise ValueError(f"{words} words hold fewer than {n} codes")
    sizes = species_sizes(g, int(spec["species"]),
                          float(spec["zipf_exponent"]))
    rng = numpy_rng(seed, 2)
    species_of = rng.permutation(np.repeat(np.arange(sizes.size), sizes))
    subs = np.rint(rng.uniform(*spec["substitution"], g) * n).astype(
        np.int64)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) & (2 ** 63 - 1))
    roots = torch.randint(-2 ** 31, 2 ** 31, (sizes.size, words),
                          generator=gen, dtype=torch.int32, device=dev)
    out = torch.empty((g, words), dtype=torch.int32, device=dev)
    for s0 in range(0, g, batch):
        s1 = min(g, s0 + batch)
        rows = torch.from_numpy(species_of[s0:s1]).to(dev)
        block = roots[rows]
        m = torch.from_numpy(subs[s0:s1]).to(dev)
        site = torch.randint(0, n, (int(subs[s0:s1].sum()),), generator=gen,
                             device=dev)
        member = torch.repeat_interleave(
            torch.arange(s1 - s0, device=dev), m)
        site = torch.unique(member * (16 * words) + site)   # distinct sites
        base = torch.randint(1, 4, site.shape, generator=gen, device=dev)
        # distinct sites fill distinct 2-bit lanes, so a sum is their xor
        flips = torch.zeros((s1 - s0) * words, dtype=torch.int64, device=dev)
        flips.index_add_(0, site // 16, base << (2 * (site % 16)))
        out[s0:s1] = block ^ _as_i32(flips).view(s1 - s0, words)
    return out, species_of


def shuffle_within_blocks(genomes, seed: int, block: int) -> np.ndarray:
    """Shuffle the rows of the (G, words) tensor in place within each run
    of `block` rows, by permutations drawn from the seed; the blocks keep
    their order.  Returns src: the row that held each row's genome before
    (new row i holds old row src[i])."""
    import torch
    g = genomes.shape[0]
    rng = numpy_rng(seed, 6)
    src = np.concatenate([b0 + rng.permutation(min(block, g - b0))
                          for b0 in range(0, g, block)])
    for b0 in range(0, g, block):
        rows = torch.from_numpy(src[b0:b0 + block]).to(genomes.device)
        genomes[b0:b0 + block] = genomes[rows]
    return src


def sample_genomes(seed: int, species_of: Sequence[int], count: int,
                   always: Sequence[int] = (), block: int = 128,
                   per_species: int = 3) -> np.ndarray:
    """`count` distinct genome ids to check, drawn from the seed: `always`
    first, then members of species drawn by size (`per_species` each, so
    that related pairs are compared), then the rest uniform; past
    `always`, a genome joins only while its `block` holds no sampled
    genome yet, so that the sample spreads over the blocks and their
    tiles."""
    rng = numpy_rng(seed, 3)
    species_of = np.asarray(species_of)
    g = species_of.size
    chosen: List[int] = [int(i) for i in always if 0 <= int(i) < g][:count]
    blocks = {i // block for i in chosen}
    free = (g + block - 1) // block

    def take(i: int) -> bool:
        if i in chosen or (i // block in blocks and len(blocks) < free):
            return False
        chosen.append(i)
        blocks.add(i // block)
        return True

    seen = set()
    for sp in species_of[rng.permutation(g)]:
        if len(chosen) + per_species > count * 3 // 4:
            break
        members = np.flatnonzero(species_of == sp)
        if members.size < 2 or int(sp) in seen:
            continue
        seen.add(int(sp))
        for i in rng.permutation(members):
            if sum(species_of[j] == sp for j in chosen) >= per_species:
                break
            take(int(i))
    for i in rng.permutation(g):
        if len(chosen) >= count:
            break
        take(int(i))
    return np.array(sorted(chosen[:count]), np.int64)
