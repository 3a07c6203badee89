"""One driver a kind of traffic; a mix's file names its driver."""
