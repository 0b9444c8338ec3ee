"""SNP grouping strategies for regional/grouped analyses.

Parity: Genotype::groupSNPs and the GroupBy enum (genotype.h:42-51,
genotype.cpp:1293-1566).  A copy of dissect_tpu/io/groups.py:
  by_position           overlapping fixed-bp windows per chromosome
  by_gene / by_group    from a regions file (SNP -> group, or gene spans)
  by_ordered_fixed_size chromosome-bounded ordered chunks of fixed count
  by_all                one group with everything
  by_file_ordered_windows fixed-count windows in file order
Each takes PLINK or BGEN data (anything with `snps` and `snp_names`).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List

Groups = "OrderedDict[str, List[str]]"  # group name -> SNP names (file order)


def by_all(data) -> Groups:
    return OrderedDict([("all", list(data.snp_names))])


def by_ordered_fixed_size(data, group_size: int) -> Groups:
    """Ordered chunks of `group_size`; chromosome boundaries split groups
    (genotype.h:47)."""
    groups: Groups = OrderedDict()
    current: List[str] = []
    current_chrom = None
    idx = 1
    for snp in data.snps:
        if current and (len(current) >= group_size or snp.chromosome != current_chrom):
            groups[f"group_{idx}"] = current
            idx += 1
            current = []
        current_chrom = snp.chromosome
        current.append(snp.name)
    if current:
        groups[f"group_{idx}"] = current
    return groups


def by_file_ordered_windows(data, window_size: int) -> Groups:
    """Fixed-count windows in file order (genotype.cpp:1480+)."""
    groups: Groups = OrderedDict()
    names = data.snp_names
    for idx, start in enumerate(range(0, len(names), window_size), 1):
        groups[f"window_{idx}"] = names[start : start + window_size]
    return groups


def by_position(data, region_size: int, overlap: int = 0) -> Groups:
    """Overlapping bp windows per chromosome (groupSNPsByPosition,
    genotype.cpp:1346-1440): regions start every (region_size - overlap)
    bp; a SNP belongs to every region covering its position."""
    if overlap >= region_size:
        raise ValueError("overlap must be smaller than region size")
    stride = region_size - overlap
    groups: Groups = OrderedDict()
    for snp in data.snps:
        pos = snp.position_bp
        region = max(0, (pos - region_size) // stride + 1)
        while region * stride <= pos:
            if pos < region * stride + region_size:
                groups.setdefault(f"{snp.chromosome}_{region}", []).append(snp.name)
            region += 1
    return groups


def by_group_file(data, path: str) -> Groups:
    """Regions file with 'SNP GROUP' rows (byGroup, genotype.cpp:1442+)."""
    mapping: Dict[str, str] = {}
    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if len(parts) >= 2:
                mapping[parts[0]] = parts[1]
    groups: Groups = OrderedDict()
    for name in data.snp_names:
        group = mapping.get(name)
        if group is not None:
            groups.setdefault(group, []).append(name)
    return groups


def by_gene_file(data, path: str) -> Groups:
    """Regions file with 'GENE CHR START END' spans (byGene,
    genotype.cpp:1442+): a SNP joins every gene span covering it."""
    spans = []
    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if len(parts) >= 4:
                spans.append((parts[0], parts[1], int(parts[2]), int(parts[3])))
    groups: Groups = OrderedDict()
    for snp in data.snps:
        for gene, chrom, start, end in spans:
            if snp.chromosome == chrom and start <= snp.position_bp <= end:
                groups.setdefault(gene, []).append(snp.name)
    return groups
