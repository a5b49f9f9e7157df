# Synthetic event data (seeded numpy generator, bit-identical to the
# reference's).
