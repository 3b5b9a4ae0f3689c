"""Write the benchmark's text corpora from the repo's transcripts.

    python -m benchmark.texts.make_texts

Each filelist line ``path|text|speaker`` whose text the served frontend
turns into 1..128 ids (the server's largest text bucket; ``p_arpabet``
0) becomes a line ``speaker|text`` of ``benchmark/texts/<corpus>.txt``;
the lines left out are counted in ``<corpus>.json``. The corpora are
kept in the benchmark so that later edits of ``filelists/`` do not move
its traffic.
"""

import json
import os

from benchmark.reference.frontend import TextIds

HERE = os.path.dirname(os.path.abspath(__file__))
MAX_IDS = 128
CORPORA = {
    "ljs": "filelists/ljs_audiopaths_text_sid_train_filelist.txt",
    "libritts": "filelists/libritts_train_clean_100_audiopath_text_sid_"
                "shorterthan10s_atleast5min_train_filelist.txt",
}


def main():
    frontend = TextIds({"cmudict_path": "data/cmudict_dictionary",
                        "p_arpabet": 0.0})
    for name, path in CORPORA.items():
        kept, total = [], 0
        with open(path, encoding="utf-8") as f:
            for line in f:
                parts = line.rstrip("\n").split("|")
                if len(parts) < 3:
                    continue
                total += 1
                n = len(frontend.ids(parts[1]))
                if 1 <= n <= MAX_IDS:
                    kept.append(f"{int(parts[2])}|{parts[1]}")
        with open(os.path.join(HERE, f"{name}.txt"), "w",
                  encoding="utf-8") as f:
            f.write("\n".join(kept) + "\n")
        with open(os.path.join(HERE, f"{name}.json"), "w") as f:
            json.dump({"source": path, "lines": total, "kept": len(kept),
                       "left_out_share": (total - len(kept)) / total,
                       "max_ids": MAX_IDS}, f, indent=1)
            f.write("\n")
        print(name, total, len(kept), (total - len(kept)) / total)


if __name__ == "__main__":
    main()
