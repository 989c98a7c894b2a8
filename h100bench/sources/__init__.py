"""
Where a training cell's rows come from: the traffic file's 'source'
names a module here, whose `Source(cell)` gives the program's feed
(`feed()`, an iterator of batches), the reference's form of row k
(`reference_row(k)`, made again from the seed) and `close()`.
"""
