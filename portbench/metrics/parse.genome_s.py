"""parse.genome_s (layer host parse): per job, the program's `genome.load`
span (engine/driver.py load_texts: each text's FASTA parse, 2-bit pack and
upload to the card); the mean over the window's jobs."""

from portbench import span_sums


def read(run):
    return span_sums.mean(run, "genome.load")
