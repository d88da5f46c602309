"""One job a kind of traffic; a traffic file names its job."""
